"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Continuous-batching server over the port's model zoo on one device, with
random weights drawn from a seeded ``torch.Generator`` on that device.
Feeds a synthetic request stream and reports tokens/s per phase.  Runs on
``cuda`` unless ``--device cpu`` is given.  ``--policy`` places the params
and the KV cache (``auto``: the planner picks for the serve phase;
otherwise a registered name, the ``role=tier[:strategy]`` grammar or JSON),
``--calibration`` prices the planner's pick on a measured hardware model.
``--max-queue`` bounds the waiting requests (backpressure) and
``--preempt`` turns on planner-priced preemption (on a card the spill
tier is pinned host memory).  The reference's ``pools=`` directive
(disaggregated serving) is ROADMAP A13.

``--mesh`` is read as the reference's serving launcher reads it: the
axes are ``("data", "model")[-len(dims):]``, so ``2x2`` is (data, model),
``2`` is a ``model`` axis of 2, and a mesh of one rank (``1x1``, the
default) is no mesh.  A mesh of several ranks serves one process a rank
under ``torchrun`` (gloo with ``--device cpu``, nccl on cards, each rank
driving ``cuda:<LOCAL_RANK>``): every rank draws the same weights and
requests and keeps its shards (``batch`` on ``data``, Megatron over
``model``), e.g.

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch yi-6b --smoke --device cpu --mesh 2x2

Only rank 0 logs the results (each request's tokens, then the rates).
The reference's ``--donor`` and ``--remote-donor`` axes are not taken
(ROADMAP A10c).
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.placement import registered_policies
from repro_torch.launch.train import join_mesh, rank_device
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.serve import (
    QueueFullError,
    Request,
    SamplingParams,
    ServeConfig,
    Server,
)

log = logging.getLogger("repro_torch.serve")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed and per-request sampling seed base "
                         "(request rid is added)")
    ap.add_argument(
        "--policy", default="auto",
        help="'auto' consults the placement planner; otherwise a registered "
             f"name ({', '.join(registered_policies())}), the compact "
             "role=tier[:strategy][,...] grammar (e.g. "
             "'kv=host:stream,params=host:stream'), or policy JSON")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on waiting requests (backpressure); default unbounded")
    ap.add_argument("--preempt", action="store_true",
                    help="enable planner-priced preemption: starved waiters may "
                         "evict a victim slot's rows to the cheapest realizable "
                         "far tier (pinned host memory on a card)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="price placements on a measured hardware model: load "
                         "this calibration.json, or calibrate on the device and "
                         "save it there (spec-sheet constants otherwise)")
    ap.add_argument("--mesh", default="1x1",
                    help="e.g. 2x2 -> (data, model); 2 -> model; a mesh of several "
                         "ranks runs under torchrun, one process a rank (donor axes, "
                         "the reference's --donor/--remote-donor: ROADMAP A10c)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = rank_device(resolve_device(args.device))
    mesh = join_mesh(args.mesh, *parse_mesh(args.mesh), device)
    try:
        out = _serve(args, device, mesh)
        if mesh is not None:
            dist.barrier()      # without it a gloo rank can abort at exit
        return out
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``--mesh``'s shape and axis names, as the reference's serving
    launcher reads them: the trailing ones of ``("data", "model")``."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) > 2:
        raise SystemExit(f"--mesh {spec}: serving takes (data, model) or (model,)")
    return dims, ("data", "model")[-len(dims):]


def _serve(args: argparse.Namespace, device: torch.device, mesh) -> dict:
    rank = dist.get_rank() if mesh is not None else 0
    if args.calibration:
        from repro_torch.core.calibration import load_or_calibrate

        # on a mesh rank 0 calibrates and writes the file; the others load it
        if rank:
            dist.barrier()
        cal = load_or_calibrate(args.calibration, activate=True, device=device)
        if mesh is not None and not rank:
            dist.barrier()
        if not rank:
            log.info("calibrated hardware model active:\n%s", cal.summary())
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = ModelBundle(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = bundle.init_params(gen)
    server = Server(
        bundle,
        ServeConfig(
            batch_slots=args.slots,
            max_len=args.max_len,
            prefill_chunk=args.prefill_chunk,
            policy=None if args.policy == "auto" else args.policy,
            max_queue=args.max_queue,
            preempt=args.preempt,
        ),
        params,
        device=device,
        mesh=mesh,
    )
    if rank == 0:
        log.info("serving under placement policy %s%s", server.policy.name,
                 f" on the mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}" if mesh else "")
    rng = np.random.default_rng(args.seed)
    requests = [
        Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            sampling=SamplingParams(
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, seed=args.seed + rid,
            ),
        )
        for rid in range(args.requests)
    ]
    pending = list(requests)
    t0 = time.perf_counter()
    # a bounded queue takes the stream as it drains
    while pending or server.has_work():
        while pending:
            try:
                server.add_request(pending[0])
            except QueueFullError:
                break
            pending.pop(0)
        server.step()
    dt = time.perf_counter() - t0
    tp = server.throughput()
    total = tp["decode_tokens"]
    st = server.stats()
    if rank:
        return tp
    for req in requests:
        log.info("request %d tokens %s", req.rid, " ".join(map(str, req.out_tokens)))
    log.info(
        "served %d requests, %d tokens in %.2fs -> %.1f tok/s on %s | "
        "prefill %.1f tok/s | decode %.1f tok/s | %d preemptions, %d promotions, "
        "peak queue %d",
        args.requests, total, dt, total / dt, device,
        tp["prefill_tps"], tp["decode_tps"], st["preemptions"], st["promotions"],
        st["peak_queue"],
    )
    return tp


if __name__ == "__main__":
    main()
