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
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.placement import registered_policies
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
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = resolve_device(args.device)
    if args.calibration:
        from repro_torch.core.calibration import load_or_calibrate

        cal = load_or_calibrate(args.calibration, activate=True, device=device)
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
    )
    log.info("serving under placement policy %s", server.policy.name)
    rng = np.random.default_rng(args.seed)
    pending = [
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
