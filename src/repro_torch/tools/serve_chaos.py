"""Chaos soak: the serve loop must heal itself under a seeded fault plan.

    python -m repro_torch.tools.serve_chaos [--requests 64] [--seed 0] [--device cpu]

Counterpart of the reference's ``tools/serve_chaos.py`` on one device.
The cache is placed ``kv_host`` (pinned host memory, streamed), and the
plan's tier loss is that ``host`` tier, since one device has no donor
tier.  Asserts:

1. ``--requests`` queued-arrival requests drain under a seeded
   :class:`~repro_torch.core.faults.FaultPlan` carrying a ``host`` tier
   loss at a decode pass, one transient migration failure, one stalled
   decode past the watchdog's deadline and one corrupted spill; every
   request ends, and the loop is bounded;
2. the tier loss drove an evacuation (the cache moved to the device's
   memory, the steps rebuilt), the failed migration was retried, the
   stall was seen by the watchdog, the corrupted spill was replayed;
3. greedy tokens are those of a no-fault, no-preemption run;
4. completion, the recovery counters, tail latency and the fault plan
   with its firing record are merged into ``--out``
   (``build/BENCH_chaos.json``).

Runs on the card unless ``--device cpu``; exits non-zero on a failure.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.faults import FaultEvent, FaultKind, FaultPlan
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import Role
from repro_torch.models.model_zoo import get_smoke_bundle
from repro_torch.serve import ServeConfig, Server
from repro_torch.tools.serve_soak import (
    BUILD,
    drain,
    greedy_divergence,
    make_request,
    merge,
    percentiles,
)

log = logging.getLogger("repro_torch.tools.serve_chaos")

#: the placement whose far tier the plan loses
POLICY = "kv_host"


def build_plan(seed: int, stall_s: float = 1.0) -> FaultPlan:
    """Seeded schedule: the rng picks *when*, the structure is fixed.

    The transient MIGRATE_FAIL sits at migrate pass 0 — the loop's only
    ``migrate()`` calls are the evacuation's — so the evacuation's first
    attempt fails and is retried.  The SPILL_CORRUPT hits the first spill,
    early enough that its promotion (and its check) lands before the tier
    loss does."""
    rng = np.random.default_rng(seed)
    return FaultPlan([
        FaultEvent("decode", at=int(rng.integers(8, 16)), kind=FaultKind.STALL,
                   seconds=stall_s),
        FaultEvent("spill", at=0, kind=FaultKind.SPILL_CORRUPT),
        FaultEvent("decode", at=int(rng.integers(28, 44)), kind=FaultKind.TIER_LOSS,
                   tier="host"),
        FaultEvent("migrate", at=0, kind=FaultKind.MIGRATE_FAIL, error="transient"),
    ], seed=seed)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--preempt-wait", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(BUILD / "BENCH_chaos.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    device = resolve_device(args.device)
    bundle = get_smoke_bundle(args.arch)
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    plan = build_plan(args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = [make_request(i, bundle.cfg.vocab, rng) for i in range(args.requests)]
    server = Server(bundle, ServeConfig(
        batch_slots=args.slots, max_len=args.max_len, prefill_chunk=8,
        max_queue=args.requests, preempt=True, preempt_wait=args.preempt_wait,
        policy=POLICY, faults=plan, verify_spills=True), params, device=device)
    log.info("chaos: %d requests -> %d slots on %s (policy %s), %d scheduled faults "
             "(seed %d)", args.requests, args.slots, device, server.policy.name,
             len(plan.events), args.seed)
    drain(server, reqs)
    undrained = [r.rid for r in reqs if not r.done]
    if undrained:
        log.error("non-terminal requests after drain: %s", undrained)
        return 1
    stats = server.stats()
    missing = {ev.kind for ev in plan.events} - {ev.kind for _, _, ev in plan.fired}
    if missing:
        log.error("scheduled fault kinds never fired: %s (fired: %s) — re-tune the "
                  "plan windows", sorted(k.value for k in missing),
                  plan.to_json()["fired"])
        return 1
    if (stats["tier_losses"] < 1 or stats["evacuations"] < 1
            or server.policy.placement(Role.KV_CACHE).tier is not MemoryTier.HBM):
        log.error("tier loss did not drive an evacuation (tier_losses=%d, "
                  "evacuations=%d, policy %s)", stats["tier_losses"],
                  stats["evacuations"], server.policy.name)
        return 1
    if stats["migration_retries"] < 1 or stats["watchdog_stalls"] < 1:
        log.error("injected migration failure retried %d times, watchdog stalls %d",
                  stats["migration_retries"], stats["watchdog_stalls"])
        return 1
    if stats["spill_corruptions"] != 1 or stats["requeued_fresh"] < 1:
        log.error("spill corruption path not exercised (spill_corruptions=%d, "
                  "requeued_fresh=%d)", stats["spill_corruptions"],
                  stats["requeued_fresh"])
        return 1
    diverged = greedy_divergence(
        bundle, params, device,
        ServeConfig(batch_slots=args.slots, max_len=args.max_len, prefill_chunk=8,
                    policy=POLICY), reqs)
    if diverged:
        log.error("greedy token divergence under faults for rids %s", diverged)
        return 1
    row = {
        "arch": bundle.cfg.name,
        "device": str(device),
        "requests": args.requests,
        "completed": sum(r.done for r in reqs),
        "completion_rate": sum(r.done for r in reqs) / len(reqs),
        "policy": server.policy.name,
        **{k: stats[k] for k in (
            "tier_losses", "evacuations", "migration_retries", "spill_corruptions",
            "requeued_fresh", "watchdog_stalls", "watchdog_retries",
            "watchdog_evacuations", "preemptions", "promotions", "captures")},
        **{k: v for k, v in percentiles(reqs).items() if k.startswith("latency")},
        "fault_plan": plan.to_json(),
        **server.throughput(),
    }
    merge(pathlib.Path(args.out), "chaos", row)
    log.info("OK: %d/%d requests ended under %d fired faults (%d tier losses -> %d "
             "evacuations, %d migration retries, %d requeued fresh, %d watchdog "
             "stalls); greedy subset identical to the no-fault run; latency p50 %.0fms "
             "p99 %.0fms -> %s", row["completed"], args.requests, len(plan.fired),
             row["tier_losses"], row["evacuations"], row["migration_retries"],
             row["requeued_fresh"], row["watchdog_stalls"],
             row["latency_p50_s"] * 1e3, row["latency_p99_s"] * 1e3, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
