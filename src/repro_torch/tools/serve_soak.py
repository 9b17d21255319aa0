"""Soak: the scheduler under sustained oversubscribed load, on one device.

    python -m repro_torch.tools.serve_soak [--requests 64] [--device cpu]

Counterpart of the reference's ``tools/serve_soak.py``.  Asserts:

1. ``--requests`` queued-arrival requests (one a tick) with mixed sampling
   (greedy / temperature / top-k / top-p) all drain through an
   oversubscribed slot pool with planner-priced preemption on;
2. the run spilled and promoted at least once (on a card the spill tier
   is pinned host memory; on the CPU the device's own memory);
3. every greedy request's tokens equal an unloaded (no-preemption) run's;
4. per-request completion latency and time-to-first-token p50/p99 are
   merged into ``--out`` (``build/BENCH_serve.json``).

Runs on the card unless ``--device cpu``; exits non-zero on a failure.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model_zoo import get_smoke_bundle
from repro_torch.serve import Request, SamplingParams, ServeConfig, Server

log = logging.getLogger("repro_torch.tools.serve_soak")

#: where the soaks write their rows
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build"


def make_sampling(i: int) -> SamplingParams:
    """Mixed params: half greedy, half seeded sampling variants."""
    if i % 2 == 0:
        return SamplingParams()                    # greedy subset
    variant = (i // 2) % 3
    if variant == 0:
        return SamplingParams(temperature=0.9, seed=i)
    if variant == 1:
        return SamplingParams(temperature=0.7, top_k=12, seed=i)
    return SamplingParams(temperature=1.1, top_p=0.9, seed=i)


def make_request(i: int, vocab: int, rng) -> Request:
    return Request(
        rid=i,
        prompt=rng.integers(1, vocab, 4 + (i % 5)).astype(np.int32),
        max_new_tokens=4 + (i % 9),
        sampling=make_sampling(i),
    )


def drain(server, reqs, limit: int = 100_000) -> int:
    """Queued arrivals, one new request a tick, until nothing is live.
    Returns the ticks taken; raises if the loop does not drain."""
    pending, tick = list(reqs), 0
    while pending or server.has_work():
        if pending:
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        if tick > limit:
            raise RuntimeError(f"the serve loop did not drain after {tick} ticks")
    return tick


def greedy_divergence(bundle, params, device, cfg: ServeConfig, reqs) -> list[int]:
    """rids of the greedy requests whose tokens differ from an unloaded
    (no-preemption, no-fault) run's."""
    ref_server = Server(bundle, cfg, params, device=device)
    greedy = [r for r in reqs if r.sampling.temperature == 0.0]
    refs = {r.rid: Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
            for r in greedy}
    ref_server.add_requests(refs.values())
    ref_server.run_until_done(100_000)
    return [r.rid for r in greedy if r.out_tokens != refs[r.rid].out_tokens]


def percentiles(reqs) -> dict:
    lat = np.asarray([r.finished_s - r.submitted_s for r in reqs])
    ttft = np.asarray([r.first_token_s - r.submitted_s for r in reqs
                       if r.first_token_s is not None])
    return {"latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99))}


def merge(out: pathlib.Path, key: str, row: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        results = json.loads(out.read_text())
    except (OSError, ValueError):
        results = {}
    results[key] = row
    out.write_text(json.dumps(results, indent=2, sort_keys=True))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--preempt-wait", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(BUILD / "BENCH_serve.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    device = resolve_device(args.device)
    bundle = get_smoke_bundle(args.arch)
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [make_request(i, bundle.cfg.vocab, rng) for i in range(args.requests)]
    base = ServeConfig(batch_slots=args.slots, max_len=args.max_len, prefill_chunk=8)
    server = Server(bundle, ServeConfig(
        batch_slots=args.slots, max_len=args.max_len, prefill_chunk=8,
        max_queue=args.requests, preempt=True, preempt_wait=args.preempt_wait),
        params, device=device)
    spill = server.runtime.spill_placement().to_str()
    log.info("soak: %d requests -> %d slots on %s (policy %s, spill tier %s)",
             args.requests, args.slots, device, server.policy.name, spill)
    drain(server, reqs)
    if not all(r.done for r in reqs):
        log.error("undrained requests: %s", [r.rid for r in reqs if not r.done])
        return 1
    stats = server.stats()
    if stats["preemptions"] < 1 or stats["promotions"] < 1:
        log.error("soak never exercised preemption (preemptions=%d, promotions=%d) — "
                  "lower --preempt-wait or raise --requests",
                  stats["preemptions"], stats["promotions"])
        return 1
    diverged = greedy_divergence(bundle, params, device, base, reqs)
    if diverged:
        log.error("greedy token divergence under load for rids %s", diverged)
        return 1
    row = {
        "arch": bundle.cfg.name,
        "device": str(device),
        "requests": args.requests,
        "batch_slots": args.slots,
        "preemptions": stats["preemptions"],
        "promotions": stats["promotions"],
        "peak_queue": stats["peak_queue"],
        "spill_s": stats["spill_s"],
        "restore_s": stats["restore_s"],
        "spill_tier": spill,
        **percentiles(reqs),
        **server.throughput(),
    }
    merge(pathlib.Path(args.out), "soak", row)
    log.info("OK: %d requests drained through %d preemptions / %d promotions "
             "(spill -> %s); greedy subset token-identical to the unloaded run; "
             "latency p50 %.0fms p99 %.0fms, ttft p50 %.0fms p99 %.0fms -> %s",
             args.requests, stats["preemptions"], stats["promotions"], spill,
             row["latency_p50_s"] * 1e3, row["latency_p99_s"] * 1e3,
             row["ttft_p50_s"] * 1e3, row["ttft_p99_s"] * 1e3, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
