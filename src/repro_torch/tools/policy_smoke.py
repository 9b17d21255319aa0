"""Smoke: a custom policy serves and survives one live replan, on one device.

    python -m repro_torch.tools.policy_smoke [--policy "kv=host:stream"] [--device cpu]

Counterpart of the reference's ``tools/policy_smoke.py``.  Asserts:

1. ``--policy`` (the compact grammar or JSON, deliberately not a
   registered name) serves the smoke config end to end through the
   :class:`~repro_torch.api.Runtime`;
2. mid-serve, ``Server.replan(--target)`` (default ``hbm_resident``)
   migrates the live cache (and the params, if their placement changed):
   on one device a real move between pinned host memory and the device's
   memory, with the steps rebuilt (on a card both graphs captured again);
3. the greedy tokens of the migrated run equal an uninterrupted run's,
   with exactly one migration.

Runs on the card unless ``--device cpu``; exits non-zero on a failure.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.placement import parse_policy, registered_policies
from repro_torch.models.model_zoo import get_smoke_bundle
from repro_torch.serve import Request, ServeConfig, Server

log = logging.getLogger("repro_torch.tools.policy_smoke")


def serve_tokens(bundle, params, device, policy, *, requests: int, prompt_len: int,
                 max_new: int, migrate_at: int | None = None, target=None):
    """One serve run; optionally a live migration after ``migrate_at``
    steps.  Returns (per-request token lists, server)."""
    server = Server(bundle, ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4,
                                        policy=policy), params, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, bundle.cfg.vocab, prompt_len)
                    .astype(np.int32), max_new_tokens=max_new)
            for i in range(requests)]
    server.add_requests(reqs)
    steps = 0
    while server.has_work():
        server.step()
        steps += 1
        if migrate_at is not None and steps == migrate_at and not server.replan(target):
            raise SystemExit(f"replan({target!r}) did not migrate (policy already "
                             f"{server.policy.name})")
        if steps > 500:
            raise SystemExit("serve loop did not drain")
    return [r.out_tokens for r in reqs], server


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="kv=host:stream",
                    help="custom serving policy (compact grammar or JSON); must NOT be "
                         "a registered name")
    ap.add_argument("--target", default="hbm_resident",
                    help="the mid-serve replan's target (any policy spelling)")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    policy = parse_policy(args.policy)
    if args.policy in registered_policies():
        raise SystemExit(f"--policy {args.policy!r} is a registered name; pass a custom "
                         "string/JSON policy (e.g. 'kv=host:stream')")
    device = resolve_device(args.device)
    log.info("policy smoke on %s: custom policy %s -> migrate to %s", device,
             policy.name, args.target)
    bundle = get_smoke_bundle(args.arch)
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    kw = dict(requests=args.requests, prompt_len=args.prompt_len, max_new=args.max_new)
    base, _ = serve_tokens(bundle, params, device, policy, **kw)
    moved, server = serve_tokens(bundle, params, device, policy, migrate_at=3,
                                 target=args.target, **kw)
    if base != moved:
        log.error("token mismatch across migration:\n  static:   %s\n  migrated: %s",
                  base, moved)
        return 1
    if server.stats()["migrations"] != 1:
        log.error("expected exactly 1 migration, got %d", server.stats()["migrations"])
        return 1
    log.info("OK: %d requests served under %s, one live migration to %s (%d captures), "
             "greedy tokens identical; final policy JSON:\n%s", args.requests,
             policy.name, server.policy.name, server.stats()["captures"],
             json.dumps(json.loads(server.policy.to_json()), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
