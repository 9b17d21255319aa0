"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py`` on one device: model bundle, the
synthetic data pipeline with prefetch, the train step and the supervisor
with async checkpoints and straggler monitoring.  Runs on ``cuda`` unless
``--device cpu`` is given (the smoke configs run end to end on a CPU);
asking for CUDA without a card raises.

``--policy`` places the train state (``auto``: the planner picks for the
train phase; otherwise any ``parse_policy`` spelling — ``opt_host``
streams the optimizer state from pinned host memory), ``--calibration``
prices the pick on a measured hardware model.  Left out until the mesh is
ported (ROADMAP A10/A8): the reference's ``--mesh``, ``--donor``,
``--remote-donor`` and ``--compress-pod-grads``.
"""

from __future__ import annotations

import argparse
import logging
import math
import pathlib
import time

import torch

from repro_torch import resolve_device
from repro_torch.api import Runtime
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.multimodal import frontend_input_defs
from repro_torch.models.sharding import torch_dtype
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

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


def train(args: argparse.Namespace) -> dict:
    """Run the training loop; returns the losses, grad norms, step times
    and the supervisor's restart count."""
    device = resolve_device(args.device)
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
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 5 + 1)),
        policy=pick_policy(bundle, args, device),
    )
    log.info("training under placement policy %s", tcfg.policy)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, ef = init_train_state(bundle, gen, tcfg)
    step_fn = make_train_step(bundle, tcfg)

    # a frontend model's batch also carries its stub embeddings, N(0, 1)
    # drawn on the device, seeded by the count of steps run; a VLM's text
    # is shorter by its patches (text_len), so that patches and text fill
    # --seq: the batch of ModelBundle.input_defs (ROADMAP C: the
    # reference's launcher passes no stubs)
    front = frontend_input_defs(cfg, args.batch)
    stub_gen = torch.Generator(device=device) if front else None
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=text_len,
                                  global_batch=args.batch))
    it = Prefetcher(data)
    ckpt = Checkpointer(args.ckpt_dir)
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
            batch.update({k: torch.randn(p.shape, generator=stub_gen, device=device).to(
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
