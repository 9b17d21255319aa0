"""Deterministic fault injection: the harness behind the self-healing serve runtime.

Counterpart of ``repro/core/faults.py``.  A :class:`FaultPlan` is a
seeded, step-indexed schedule of :class:`FaultEvent`\\ s that fire at
named injection *sites* — the dispatch and migration entry points of
:class:`repro_torch.api.Runtime` and the serve
:class:`~repro_torch.serve.engine.Executor` — and either raise a typed
fault, stall the caller, or hand back a data-corruption token the caller
applies to the bytes in flight.

Fault taxonomy:

* :class:`TierLossError` — a memory tier became unusable (on one card:
  pinned host memory).  The serve layer catches it, evacuates every
  affected role (:meth:`repro_torch.api.Runtime.evacuate`), and continues
  degraded.
* :class:`MigrationFault` — a *transient* migrate/realize failure
  (retryable: :func:`repro_torch.runtime.retry.retry_call` wraps
  migrations).
* ``stall`` — the dispatch takes far longer than its deadline; not an
  exception at all (access-path faults often show up as latency).  The
  :class:`repro_torch.runtime.supervisor.Watchdog` catches it.
* :class:`SpillCorruptionError` — a preemption spill round trip returned
  different bytes than it parked (detected by checksum at promotion).
  The scheduler drops the parked rows and re-queues the request as a
  ``"fresh"`` waiter whose prompt replays everything generated so far.
* :class:`TicketLossError` — the type of a lost disaggregated handoff
  ticket; its ``handoff`` site comes with disaggregated serving (ROADMAP
  A13).

Production paths pay nothing: every site guard is ``if plan:
plan.check(site)`` against the falsy :data:`NO_FAULTS` default.  Only
this module raises the injected fault types; each such raise carries the
reference lint's per-line pragma for its ``injected-fault-raise`` rule,
whose allowlist names the reference's harness module only.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
from typing import Iterable

import torch

from repro_torch.core.placement import DonorAxisError, parse_tier

__all__ = [
    "FaultKind",
    "FaultEvent",
    "FaultPlan",
    "InjectedFault",
    "TransientFault",
    "TierLossError",
    "MigrationFault",
    "SpillCorruptionError",
    "TicketLossError",
    "NO_FAULTS",
    "checksum_tree",
    "corrupt_tree",
    "verify_spill",
]


class FaultKind(str, enum.Enum):
    """What an event does when it fires."""

    TIER_LOSS = "tier_loss"          # drop a tier mid-run
    MIGRATE_FAIL = "migrate_fail"    # fail a migrate()/realize() call
    STALL = "stall"                  # stall a dispatch past its deadline
    SPILL_CORRUPT = "spill_corrupt"  # corrupt a spill round trip
    TICKET_LOSS = "ticket_loss"      # drop a disagg handoff ticket in flight


class InjectedFault(RuntimeError):
    """Base class of every fault the harness raises."""


class TransientFault(InjectedFault):
    """A fault that may succeed on retry — what retry policies wrap."""


class TierLossError(InjectedFault):
    """A memory tier (and everything parked on it) became unusable.

    Carries the lost :class:`~repro_torch.core.hardware.MemoryTier`; the
    serve layer's recovery path (``Server._recover_tier_loss``) marks it
    lost on the runtime, evacuates affected roles, and re-queues spilled
    sequences whose parked rows lived there.
    """

    def __init__(self, tier, message: str = ""):
        self.tier = parse_tier(tier)
        super().__init__(
            message or f"tier {self.tier.value} lost: donor axis dropped"
        )


class MigrationFault(TransientFault):
    """A transient migrate/realize failure (link hiccup surrogate)."""


class TicketLossError(InjectedFault):
    """A disaggregated handoff ticket vanished in flight (ROADMAP A13
    brings the site that raises it)."""

    def __init__(self, rid: int, message: str = ""):
        self.rid = rid
        super().__init__(
            message or f"handoff ticket for rid {rid} lost in flight; "
            "replaying the request through the prefill pool"
        )


class SpillCorruptionError(InjectedFault):
    """A promoted spill's bytes differ from what was parked."""

    def __init__(self, rid: int, expected: float, got: float):
        self.rid = rid
        self.expected = expected
        self.got = got
        super().__init__(
            f"spilled rows for rid {rid} failed their integrity check "
            f"(checksum {got!r} != {expected!r} at spill time); dropping "
            "the parked rows and replaying the sequence"
        )


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``site`` names the injection point (``decode`` / ``prefill`` /
    ``migrate`` / ``realize`` / ``extract`` / ``spill`` / ``handoff`` /
    ``checkpoint``); ``at`` is the 0-indexed pass through that site on
    which the event fires, and ``times`` how many *consecutive* passes it
    keeps firing for (>1 models a fault that outlives one retry).
    """

    site: str
    at: int
    kind: FaultKind
    #: TIER_LOSS target, any ``parse_tier`` spelling ("peer_hbm", "host")
    tier: str | None = None
    #: STALL duration
    seconds: float = 0.0
    times: int = 1
    #: MIGRATE_FAIL flavor: "transient" raises the retryable
    #: MigrationFault; "donor" raises DonorAxisError (permanent)
    error: str = "transient"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind.value
        return d


class FaultPlan:
    """A deterministic, step-indexed schedule of injected faults.

    Sites call :meth:`check` once per pass; the plan counts passes per
    site and fires the events whose ``[at, at + times)`` window covers
    the current index.  Everything is decided by construction — no
    randomness at fire time — so a seeded schedule replays exactly.
    The falsy :data:`NO_FAULTS` (an empty plan) is the production default.
    """

    def __init__(self, events: Iterable[FaultEvent] = (), seed: int = 0):
        self.events = tuple(events)
        self.seed = int(seed)
        self._counts: dict[str, int] = {}
        #: every fired (site, index, event), in firing order
        self.fired: list[tuple[str, int, FaultEvent]] = []

    def __bool__(self) -> bool:
        return bool(self.events)

    def __repr__(self) -> str:
        return (
            f"FaultPlan(seed={self.seed}, events={len(self.events)}, "
            f"fired={len(self.fired)})"
        )

    def site_count(self, site: str) -> int:
        """Passes through ``site`` so far."""
        return self._counts.get(site, 0)

    def check(self, site: str, *, rid: int = -1) -> FaultEvent | None:
        """Count one pass through ``site`` and fire any matching event.

        TIER_LOSS, MIGRATE_FAIL and TICKET_LOSS raise; STALL sleeps on the
        host and returns the event; SPILL_CORRUPT returns the event for
        the caller to apply.  Returns ``None`` when nothing fires.
        """
        idx = self._counts.get(site, 0)
        self._counts[site] = idx + 1
        hit: FaultEvent | None = None
        for ev in self.events:
            if ev.site != site or not ev.at <= idx < ev.at + ev.times:
                continue
            self.fired.append((site, idx, ev))
            if ev.kind is FaultKind.STALL:
                time.sleep(ev.seconds)
                hit = ev
            elif ev.kind is FaultKind.TIER_LOSS:
                raise TierLossError(ev.tier or "peer_hbm")  # repro: lint-disable=injected-fault-raise
            elif ev.kind is FaultKind.TICKET_LOSS:
                raise TicketLossError(rid)  # repro: lint-disable=injected-fault-raise
            elif ev.kind is FaultKind.MIGRATE_FAIL:
                if ev.error == "donor":
                    raise DonorAxisError(
                        f"injected donor-axis failure at {site}[{idx}]"
                    )
                raise MigrationFault(  # repro: lint-disable=injected-fault-raise
                    f"injected transient {site} failure at pass {idx}"
                )
            else:  # SPILL_CORRUPT: data fault, applied by the caller
                hit = ev
        return hit

    def to_json(self) -> dict:
        """Schedule + firing record, for the chaos soak's artifact."""
        return {
            "seed": self.seed,
            "events": [ev.to_json() for ev in self.events],
            "fired": [
                {"site": site, "index": idx, **ev.to_json()}
                for site, idx, ev in self.fired
            ],
        }

    def summary(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)


#: the production default: no events, falsy, check() never fires.
NO_FAULTS = FaultPlan()


# ---------------------------------------------------------------------------
# Spill-integrity helpers (checksum at park time, verify at promotion)
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """Leaves in the reference's order: dict entries by sorted key, lists
    and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def checksum_tree(tree) -> float:
    """Order-deterministic checksum of a tree's values: one float32 sum
    per leaf, in leaf order, on the device each leaf lies on (host rows
    sum on the CPU, their mapped view on the card).  The same bytes summed
    the same way on the same device give the same float, so parked rows
    are verified at promotion without a second copy.  Only spill/promote
    lifecycle events pay for it, and only when spill verification is on."""
    total = 0.0
    for leaf in _leaves(tree):
        total += float(torch.sum(leaf, dtype=torch.float32))
    return total


def corrupt_tree(tree):
    """Add 1 to element ``(0,) * ndim`` of the first leaf, in place — the
    SPILL_CORRUPT payload; returns ``tree``.  Deterministic and minimal:
    enough to trip :func:`checksum_tree` without masking bookkeeping bugs
    behind large damage.  In place, so parked rows stay where they were
    parked (pinned host rows stay pinned)."""
    leaves = _leaves(tree)
    if leaves:
        x = leaves[0]
        x[(0,) * x.ndim] += 1
    return tree


def verify_spill(rows, checksum: float | None, rid: int, *, agree=None) -> None:
    """Raise :class:`SpillCorruptionError` when ``rows`` no longer match
    the checksum taken at spill time (``checksum=None`` skips — spills are
    only checksummed when verification is enabled, and on a mesh only the
    rank that holds the rows has them).  ``agree`` (the serving mesh's
    ``Ranks.all_ok``) turns each rank's verdict into one every rank
    takes, so all of them replay the request or none does."""
    got = None if checksum is None else checksum_tree(rows)
    ok = got == checksum
    if agree is not None:
        ok = agree(ok)
    if not ok:
        raise SpillCorruptionError(rid, checksum, got)  # repro: lint-disable=injected-fault-raise
