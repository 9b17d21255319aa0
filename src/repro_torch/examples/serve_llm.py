"""Batched serving example: continuous batching, sampling, streaming.

    python -m repro_torch.examples.serve_llm [--policy kv_host] [--asyncio] [--device cpu]

Counterpart of the reference's ``examples/serve_llm.py``.  Serves a
stream of synthetic requests through the layered serve stack — batched
admission into the chunked prefill path, in-place cache decode steps
(CUDA graphs on the card) with per-request sampling on the device — and
reports prefill against decode tokens/s per placement policy: the paper's
Fig. 17 experiment as a service loop.  Requests mix greedy decode with
seeded temperature/top-k/top-p sampling, tokens stream through
``on_token`` callbacks as they decode, and ``--asyncio`` drives the same
workload through the asyncio :class:`~repro_torch.serve.Scheduler`
(``await submit()`` / ``async for tok in stream()``).  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.placement import registered_policies
from repro_torch.models.model_zoo import get_smoke_bundle
from repro_torch.serve import Request, SamplingParams, Scheduler, ServeConfig, Server


def make_sampling(i: int) -> SamplingParams:
    """Alternate greedy and seeded nucleus sampling across requests."""
    if i % 2 == 0:
        return SamplingParams()  # temperature=0 -> greedy
    return SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=i)


def run_sync(bundle, params, args, pname, rng, device) -> list[list[int]]:
    server = Server(
        bundle,
        ServeConfig(batch_slots=3, max_len=128, prefill_chunk=args.prefill_chunk,
                    policy=pname),
        params, device=device,
    )
    streamed: dict[int, int] = {}

    def on_token(req: Request, tok: int) -> None:
        # fires the tick each token is decoded; req.done marks the last
        streamed[req.rid] = streamed.get(req.rid, 0) + 1

    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, bundle.cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            sampling=make_sampling(i),
            on_token=on_token,
        )
        for i in range(args.requests)
    ]
    server.add_requests(reqs)          # batched admission
    t0 = time.perf_counter()
    server.run_until_done()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    assert streamed == {r.rid: len(r.out_tokens) for r in reqs}
    tp = server.throughput()
    print(
        f"[{server.policy.name}] {args.requests} requests, {total} tokens in "
        f"{dt:.2f}s -> {total / dt:.1f} tok/s overall | prefill "
        f"{tp['prefill_tps']:.1f} tok/s ({tp['prefill_tokens']} tok) | "
        f"decode {tp['decode_tps']:.1f} tok/s ({tp['decode_tokens']} tok)"
    )
    for r in reqs[:2]:
        mode = "greedy" if r.sampling.temperature == 0 else (
            f"T={r.sampling.temperature} top_k={r.sampling.top_k} "
            f"top_p={r.sampling.top_p} seed={r.sampling.seed}"
        )
        print(f"  req {r.rid} ({mode}): prompt {r.prompt[:6]}... -> {r.out_tokens}")
    return [r.out_tokens for r in reqs]


async def run_async(bundle, params, args, pname, rng, device) -> list[list[int]]:
    """The same workload through the asyncio front end: submissions
    absorb backpressure, tokens stream as they decode."""
    server = Server(
        bundle,
        ServeConfig(batch_slots=3, max_len=128, prefill_chunk=args.prefill_chunk,
                    policy=pname, max_queue=max(args.requests // 2, 1)),
        params, device=device,
    )
    sched = Scheduler(server)
    prompts = [rng.integers(0, bundle.cfg.vocab, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]

    async def client(i: int) -> list[int]:
        req = await sched.submit(   # awaits queue space when full
            prompts[i], max_new_tokens=args.max_new, sampling=make_sampling(i))
        return [tok async for tok in sched.stream(req)]

    async def clients():
        outs = await asyncio.gather(*(client(i) for i in range(args.requests)))
        sched.close()
        return outs

    _, outs = await asyncio.gather(sched.run(), clients())
    total = sum(len(o) for o in outs)
    print(f"[{server.policy.name}] asyncio front end streamed {total} tokens across "
          f"{len(outs)} concurrent clients")
    return outs


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument(
        "--policy", default=None,
        help=f"a registered policy name ({', '.join(registered_policies())}), the "
             "role=tier[:strategy][,...] grammar, or policy JSON")
    ap.add_argument("--asyncio", action="store_true",
                    help="also drive the workload through the async Scheduler front end")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    bundle = get_smoke_bundle(args.arch)
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    out = {}
    for pname in [args.policy] if args.policy else ["hbm_resident"]:
        out[pname] = {"sync": run_sync(bundle, params, args, pname, rng, device)}
        if args.asyncio:
            out[pname]["asyncio"] = asyncio.run(
                run_async(bundle, params, args, pname, rng, device))
    return out


if __name__ == "__main__":
    main()
