"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py`` on one device: model bundle, the
synthetic data pipeline with prefetch, the train step and the supervisor
with async checkpoints and straggler monitoring.  Runs on ``cuda`` unless
``--device cpu`` is given (the smoke configs run end to end on a CPU);
asking for CUDA without a card raises.

``--policy`` places the train state (``auto``: the planner picks for the
train phase; otherwise any ``parse_policy`` spelling — ``opt_host``
streams the optimizer state from pinned host memory, ``weights_stream``
the params, ``params=host`` keeps them there and reads them in place),
``--calibration`` prices the pick on a measured hardware model.  The log
names each role in host memory, its placement and its bytes.

``--mesh`` takes the reference's ``AxB[xC]`` spelling (``2x1x1`` is
(pod, data, model); ``4x2`` is (data, model); ``4`` is data).  A mesh of
several ranks trains sharded by the reference's rules (ZeRO-3 over
``data``, Megatron tensor parallelism over ``model``, data parallel over
``pod``; ``train/train_step.py``): run one process per rank under
``torchrun`` (gloo with ``--device cpu``, nccl on cards; each rank drives
``cuda:<LOCAL_RANK>``), e.g.

    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
        --arch granite-8b --smoke --device cpu --mesh 2x2x2

Each rank reads its rows of the global ``--batch`` (``batch_shard``: the
ranks along ``model`` read the same rows) and writes its checkpoints
(its shards) under ``<ckpt-dir>/rank_<r>``.  ``--compress-pod-grads``
syncs the gradients over ``pod`` in int8 with error feedback; without a
pod axis of several ranks it is the reference's no-op.  ``--donor`` and
``--remote-donor`` are refused (ROADMAP A10c).
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import pathlib
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.api import Runtime
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.placement import Role, host_bytes, parse_policy
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch.mesh import make_mesh_for, mesh_axes_dict
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.multimodal import frontend_input_defs
from repro_torch.models.sharding import torch_dtype
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainConfig, batch_shard, init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")

#: default checkpoint directory: build/ckpt at the repository root (git-ignored)
DEFAULT_CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "ckpt"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1",
                    help="e.g. 2x1x1 -> (pod,data,model); 4x2 -> (data,model); a mesh "
                         "of several ranks runs under torchrun, one process a rank")
    ap.add_argument("--donor", type=int, default=1,
                    help="an ICI donor axis of this size (>= 2: ROADMAP A10c, refused)")
    ap.add_argument("--remote-donor", type=int, default=1,
                    help="a DCN donor axis of this size (>= 2: ROADMAP A10c, refused)")
    ap.add_argument("--compress-pod-grads", action="store_true",
                    help="int8 gradient sync with error feedback over the pod axis")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR),
                    help="checkpoint directory (default: build/ckpt at the "
                         "repository root)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--policy", default="auto",
                    help="'auto' consults the placement planner for the train "
                         "phase; otherwise a registered name (e.g. opt_host), "
                         "the role=tier[:strategy] grammar, or policy JSON")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="price placements on a measured hardware model: load "
                         "this calibration.json, or calibrate on the device and "
                         "save it there")
    return ap.parse_args(argv)


def pick_policy(bundle, args, device) -> str:
    """The run's placement policy: forced, or the planner's pick for the
    train phase at this batch and sequence length."""
    if args.policy != "auto":
        return args.policy
    rt = Runtime.auto(bundle, device, phase="train", batch=args.batch,
                      seq=args.seq, remat=args.remat != "none")
    log.info("planner picked %s\n%s", rt.policy.name, rt.explain("train"))
    return rt.policy.name


def log_host_roles(policy, params, opt_state) -> None:
    """Log each role ``policy`` places in host memory: its placement and
    its bytes."""
    pol = parse_policy(policy)
    trees = {Role.PARAMS: params, Role.MASTER: opt_state["master"],
             Role.OPT_STATE: {k: opt_state[k] for k in ("mu", "nu")}}
    for role, tree in trees.items():
        pl = pol.placement(role)
        if pl.on_host:
            log.info("%s in host memory (%s): %d bytes", role.value, pl.to_str(),
                     host_bytes(tree))


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``--mesh``'s shape and axis names, as the reference reads them."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):] if len(dims) > 1 else ("data",)
    return dims, axes


def rank_device(device: torch.device) -> torch.device:
    """The card this rank drives: ``cuda:<LOCAL_RANK>`` when torchrun
    started several ranks on one host, else ``device`` as given."""
    if device.type != "cuda" or "LOCAL_RANK" not in os.environ:
        return device
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    return dev


def join_mesh(spec: str, dims: tuple[int, ...], axes: tuple[str, ...],
              device: torch.device):
    """The mesh of ``dims`` over ``axes`` (``spec`` is the ``--mesh`` text
    it came from): None on one process with every axis of size 1; else the
    mesh over the process group of torchrun's environment (initialized
    here: nccl on cards, gloo on the CPU).  Exits when the processes do
    not match the mesh."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if math.prod(dims) == 1 and world == 1:
        return None
    if math.prod(dims) != world:
        raise SystemExit(f"--mesh {spec} needs {math.prod(dims)} processes, this "
                         f"run has {world}: start it under torchrun --nproc-per-node "
                         f"{math.prod(dims)}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return make_mesh_for(dims, axes)


def make_mesh(args: argparse.Namespace, device: torch.device):
    """The run's mesh (:func:`join_mesh` of ``--mesh`` read as the
    reference's training launcher reads it).  Raises naming ROADMAP A10c
    for a donor axis."""
    if args.donor > 1 or args.remote_donor > 1:
        raise SystemExit(f"--donor {args.donor} --remote-donor {args.remote_donor}: "
                         "donor axes (the peer and remote placements) are ROADMAP A10c")
    return join_mesh(args.mesh, *parse_mesh(args.mesh), device)


def train(args: argparse.Namespace) -> dict:
    """Run the training loop; returns the losses, grad norms, step times
    and the supervisor's restart count."""
    device = rank_device(resolve_device(args.device))
    mesh = make_mesh(args, device)
    try:
        return _train(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, device: torch.device, mesh) -> dict:
    rank = dist.get_rank() if mesh is not None else 0
    shard, shards = batch_shard(args.batch, mesh)
    if args.batch % shards:
        raise SystemExit(f"--batch {args.batch} does not split over {shards} ranks")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = ModelBundle(cfg)
    text_len = args.seq if bundle.encdec else args.seq - cfg.frontend_tokens
    if text_len <= 0:
        raise SystemExit(f"--seq {args.seq} leaves no text after {cfg.name}'s "
                         f"{cfg.frontend_tokens} patch positions")
    if args.calibration:
        from repro_torch.core.calibration import load_or_calibrate

        cal = load_or_calibrate(args.calibration, activate=True, device=device)
        log.info("calibrated hardware model active:\n%s", cal.summary())
    tcfg = TrainConfig(
        remat=args.remat,
        n_microbatches=args.microbatches,
        compress_pod_grads=args.compress_pod_grads,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 5 + 1)),
        policy=pick_policy(bundle, args, device),
    )
    if mesh is None:
        where = ""
    elif mesh_axes_dict(mesh).get("pod", 1) == dist.get_world_size():
        where = f", rank {rank} of {dist.get_world_size()} on the pod axis"
    else:
        where = (f", rank {rank} of {dist.get_world_size()} on the mesh "
                 f"{mesh_axes_dict(mesh)}, batch rows {shard} of {shards}")
    log.info("training under placement policy %s%s", tcfg.policy, where)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, ef = init_train_state(bundle, gen, tcfg, mesh)
    log_host_roles(tcfg.policy, params, opt_state)
    step_fn = make_train_step(bundle, tcfg, mesh)

    # a frontend model's batch also carries its stub embeddings, N(0, 1)
    # drawn on the device for the global batch, seeded by the count of
    # steps run (a rank keeps its rows); a VLM's text is shorter by its
    # patches (text_len), so that patches and text fill --seq: the batch
    # of ModelBundle.input_defs (ROADMAP C: the reference's launcher
    # passes no stubs)
    front = frontend_input_defs(cfg, args.batch)
    stub_gen = torch.Generator(device=device) if front else None
    rows = slice(shard * args.batch // shards, (shard + 1) * args.batch // shards)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=text_len,
                                  global_batch=args.batch),
                       process_index=shard, process_count=shards)
    it = Prefetcher(data)
    ckpt = Checkpointer(args.ckpt_dir if mesh is None
                        else os.path.join(args.ckpt_dir, f"rank_{rank}"))
    sup = Supervisor(ckpt, SupervisorConfig(checkpoint_every=args.ckpt_every))

    state = {"params": params, "opt": opt_state, "ef": ef}
    out = {"losses": [], "grad_norms": [], "step_s": []}

    def one_step(state, batch):
        t0 = time.perf_counter()
        # batches arrive as numpy on the prefetch thread; they move to the
        # device here, on the training thread
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if front:
            stub_gen.manual_seed(len(out["losses"]))
            batch.update({k: torch.randn(p.shape, generator=stub_gen, device=device)[rows].to(
                torch_dtype(cfg.dtype)) for k, p in front.items()})
        p, o, e, metrics = step_fn(state["params"], state["opt"], state["ef"], batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise FloatingPointError(f"loss {loss}, grad norm {gnorm}")
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        out["step_s"].append(time.perf_counter() - t0)
        if len(out["losses"]) % args.log_every == 0:
            # aux: the MoE load-balancing loss (0 without MoE layers)
            log.info("step %d loss %.4f grad_norm %.3f aux %.4f (%.3f s)",
                     len(out["losses"]), loss, gnorm, float(metrics["aux"]),
                     out["step_s"][-1])
        return {"params": p, "opt": o, "ef": e}, metrics

    try:
        state, step = sup.run(state, one_step, it, args.steps,
                              extra_state=lambda: {"data": data.state()})
    finally:
        it.close()
    out.update(state=state, steps=step, restarts=sup.restarts,
               stragglers=sup.monitor.summary())
    losses = out["losses"]
    log.info("done: %d steps, loss %.4f -> %.4f, restarts %d, straggler stats %s",
             step, losses[0] if losses else float("nan"),
             losses[-1] if losses else float("nan"), sup.restarts,
             out["stragglers"])
    return out


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    train(parse_args(argv))


if __name__ == "__main__":
    main()
