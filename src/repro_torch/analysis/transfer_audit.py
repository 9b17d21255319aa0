"""Each serving step's data movement held against its placement.

Counterpart of ``repro/analysis/hlo_audit.py``.  The reference diffs a
compiled module's text against the placement: its ``input_output_alias``
header (did donation materialize?) and the host memory space of its
copies.  The port has no compiled text; it runs the step once and reads
what the step did:

* **``missed-donation``** — a role the policy lets a step update in place
  (not STREAM) must be written in place: every leaf the step hands back
  for it keeps the storage (``untyped_storage().data_ptr()``) the leaf
  had before.  A leaf that comes back in new storage is a cache-sized
  copy per dispatch that the planner never priced.
* **``forbidden-donation``** — a role the step may not update in place
  keeps its storage across the step (a STREAM role's host source,
  ``kv_host``'s cache or ``weights_stream``'s params, is never replaced),
  and a read-only role (params) is not written: its tensors' ``_version``
  does not change in an eager step, or, for a tensor with no version
  counter (one made under ``inference_mode``), its checksum does not.
  The KV write-back into a streamed cache is the placement's own write
  (:attr:`RoleExpectation.placement_writes`), not a violation.
* **``stray-host-transfer``** — on a card, the host<->device copy records
  of the step's profiler window, read from the card's own trace
  (:func:`traced_window`, never an estimate), may not exceed the
  allowance: for a decode or prefill step the reference's ``3 ·
  batch_slots · 4`` bytes plus, under a STREAM placement, the bytes its
  ``HostStream`` windows declare (and an ``M`` layer's state copied back
  whole); for an ``insert`` the restored slot's bytes.  A kernel that
  reads or writes mapped host memory in place (a RESIDENT host placement,
  the KV write-back kernel) makes no copy record: those bytes stay the
  planner's to price.
* **``byte-plan-mismatch``** (a warning) — a role's bytes against the
  planner's ``bytes_per_role`` within a tolerance.

On the CPU the storage and version checks run and no transfer is
recorded.  Both packages' reports carry the same fields
(:meth:`AuditReport.to_json`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.op_analysis import TransferStat, transfers_from_trace
from repro_torch.models.sharding import tree_leaves

__all__ = [
    "DonationAliasError",
    "RoleExpectation",
    "ExpectedMovement",
    "AuditViolation",
    "AuditReport",
    "LeafAlias",
    "StepTarget",
    "ERROR_KINDS",
    "audit_step",
    "traced_window",
]


class DonationAliasError(RuntimeError):
    """An in-place update the policy requires did not happen (or one it
    forbids did).  Raised at ``Executor`` build time so the cost is a clear
    error, not a silent extra copy on every dispatch."""


# ---------------------------------------------------------------------------
# Expectations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoleExpectation:
    """What the policy says about one of the step's role trees."""

    role: str                     # planner role name, e.g. "kv_cache"
    arg_root: str                 # the tree's name in the step, e.g. "caches"
    donate: bool                  # may be updated in place => must be
    planner_term: str = "hbm"     # predict() term pricing this movement
    plan_bytes: float | None = None   # planner's per-step byte plan, if priced
    tolerance: float = 0.5        # relative tolerance for plan_bytes
    #: the placement itself writes the tree in place while it may not be
    #: donated (a streamed cache's write-back): not a violation
    placement_writes: bool = False


@dataclasses.dataclass(frozen=True)
class ExpectedMovement:
    """The placement's movement contract for one step."""

    roles: tuple[RoleExpectation, ...] = ()
    #: host<->device byte allowance per dispatch
    host_bytes_allowed: float = 0.0
    label: str = ""

    def role_for_root(self, root: str) -> RoleExpectation | None:
        for r in self.roles:
            if r.arg_root == root:
                return r
        return None


# ---------------------------------------------------------------------------
# Violations and the report
# ---------------------------------------------------------------------------

#: gate-failing violation kinds (severity "error")
ERROR_KINDS = ("missed-donation", "forbidden-donation", "stray-host-transfer")


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    kind: str          # one of ERROR_KINDS or "byte-plan-mismatch"
    severity: str      # "error" | "warning"
    op: str            # the leaf or copy record the violation anchors to
    nbytes: float      # bytes at stake, per dispatch
    tier_edge: str     # the datapath edge being (mis)used, e.g. "host<->hbm"
    planner_term: str  # which predict() term the movement breaks
    detail: str

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LeafAlias:
    """One in-place update that materialized: leaf ``index`` of the tree
    ``arg_root`` came back in its own storage (the reference's
    ``AliasPair``)."""

    arg_root: str
    index: int
    nbytes: int


@dataclasses.dataclass
class AuditReport:
    """Everything the audit observed, and the diff against expectations."""

    label: str
    violations: list[AuditViolation]
    transfers: list[TransferStat]
    aliases: list[LeafAlias]
    #: observed bytes per planner role
    role_bytes: dict[str, float]
    host_transfer_bytes: float
    donation_expected: int
    donation_materialized: int
    #: whether ``transfers`` are the card's records of the step
    profiled: bool = False

    @property
    def ok(self) -> bool:
        return not any(v.severity == "error" for v in self.violations)

    @property
    def donation_coverage(self) -> float:
        """Fraction of the required in-place updates that happened."""
        if self.donation_expected == 0:
            return 1.0
        return self.donation_materialized / self.donation_expected

    def bytes_by_direction(self) -> dict[str, float]:
        """Copy bytes of the step by direction ("HtoD", "DtoH", ...)."""
        out: dict[str, float] = {}
        for t in self.transfers:
            out[t.name] = out.get(t.name, 0.0) + t.nbytes
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "label": self.label,
            "ok": self.ok,
            "violations": [v.to_json() for v in self.violations],
            "host_transfer_bytes": self.host_transfer_bytes,
            "donation_expected": self.donation_expected,
            "donation_materialized": self.donation_materialized,
            "donation_coverage": self.donation_coverage,
            "role_bytes": dict(self.role_bytes),
            "n_transfers": len(self.transfers),
            "n_aliases": len(self.aliases),
            "profiled": self.profiled,
            "bytes_by_direction": self.bytes_by_direction(),
        }

    def raise_on_donation_errors(self) -> None:
        bad = [v for v in self.violations
               if v.kind in ("missed-donation", "forbidden-donation")]
        if bad:
            lines = "\n".join(f"  [{v.kind}] {v.op}: {v.detail}" for v in bad)
            raise DonationAliasError(
                f"{self.label or 'step'}: the in-place contract was not honored "
                f"({self.donation_materialized}/{self.donation_expected} written in "
                f"place):\n{lines}")


# ---------------------------------------------------------------------------
# The card's own records of a window
# ---------------------------------------------------------------------------

#: spin kernels that lead every traced window; the tracer drops the first
#: records of a window, so a window counts only what follows its last
#: leading spin.  A retake after a window that lost them all runs 8 times
#: as many, up to TRACE_MAX_SPINS, and the count that worked stays for the
#: later windows of the process (late in a long process the tracer dropped
#: the first ~83 kernel records of every window on the H100)
TRACE_LEAD_SPINS = 20
#: the most leading spins a window runs (1280: ~6 ms of spins)
TRACE_MAX_SPINS = 1280
#: profiler windows traced_window takes before it gives up
TRACE_ATTEMPTS = 5


def _trace_path():
    from repro_torch.kernels._build import build_dir

    path = build_dir().parent / "trace-window.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def traced_window(label: str, fn: Callable[[], Any], *,
                  log: Callable[[str], None] | None = None):
    """The card's own records of one call of ``fn`` (``torch.profiler``,
    CUDA activity only: kernels and copies as chrome-trace events, times
    in us) and its wall seconds.

    The tracer loses the first records of a window (on the card: the
    first two or three copies of a step, whatever precedes them in the
    process; late in a long process, the first ~83 kernel records).  So
    the window opens with ``TRACE_LEAD_SPINS`` spin kernels (8 times as
    many on each retake after a window that kept fewer than two, at most
    ``TRACE_MAX_SPINS``; a count that worked is kept from then on in the
    process), then the call, then one more spin, and only the records
    between the last leading spin and the closing one are returned.  A
    window with fewer spins than that, or with no kernel between them
    (the tracer dropped the call's records: every call measured here
    launches kernels), is taken again, up to ``TRACE_ATTEMPTS`` times,
    each retake after an empty profiler window.  ``log`` receives a line
    for each retake."""
    from torch.profiler import ProfilerActivity, profile

    global TRACE_LEAD_SPINS
    say = log or (lambda _msg: None)
    path = _trace_path()
    lead = TRACE_LEAD_SPINS
    for attempt in range(TRACE_ATTEMPTS):
        if attempt:
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        spins = sorted(e["ts"] for e in events
                       if e.get("cat") == "kernel" and "spin" in e.get("name", ""))
        if len(spins) >= 2:
            lo, hi = spins[-2], spins[-1]
            inside = [e for e in events if lo < e.get("ts", lo) < hi]
            if any(e.get("cat") == "kernel" for e in inside):
                TRACE_LEAD_SPINS = lead
                return inside, wall
            say(f"  ({label}: the profiler kept its markers but no kernel of the call; "
                "taken again)")
        else:
            n_kernels = sum(e.get("cat") == "kernel" for e in events)
            lead = min(8 * lead, TRACE_MAX_SPINS)
            say(f"  ({label}: the profiler kept {len(spins)} of its spin markers and "
                f"{n_kernels} kernel records; taken again with {lead} leading)")
    raise AssertionError(f"{label}: {TRACE_ATTEMPTS} profiler windows without the "
                         "call's records")


# ---------------------------------------------------------------------------
# The audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepTarget:
    """A step to audit: ``step()`` runs it once and returns the role trees
    it hands back (``{arg_root: tree}``, or None when it returns none);
    ``trees`` are the role trees it runs on, by ``arg_root``.  With
    ``profile`` on a card, the step runs inside a traced window and its
    copy records are audited; ``records`` gives them instead (a test's
    injected records)."""

    step: Callable[[], Mapping[str, Any] | None]
    trees: Mapping[str, Any]
    profile: bool = False
    records: Sequence[TransferStat] | None = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _stamp(t: torch.Tensor):
    """What tells whether ``t`` was written: its version counter, or for a
    tensor without one (made under ``inference_mode``) a checksum of its
    values (read on its device: the mapped view of a host tensor, over
    PCIe)."""
    if not t.is_inference():
        return ("version", t._version)
    return ("sum", float(t.sum(dtype=torch.float64)))


def audit_step(target: StepTarget, expected: ExpectedMovement,
               device: torch.device | str | None = None, *,
               log: Callable[[str], None] | None = None) -> AuditReport:
    """Run ``target``'s step once and audit it against ``expected``."""
    device = torch.device(device) if device is not None else None
    before: dict[str, list[torch.Tensor]] = {}
    ptrs: dict[str, list[int]] = {}
    stamps: dict[str, list] = {}
    for exp in expected.roles:
        leaves = [t for t in tree_leaves(target.trees.get(exp.arg_root, {}))
                  if isinstance(t, torch.Tensor)]
        before[exp.arg_root] = leaves
        ptrs[exp.arg_root] = [_ptr(t) for t in leaves]
        if not exp.donate and not exp.placement_writes:
            stamps[exp.arg_root] = [_stamp(t) for t in leaves]

    profiled = False
    if target.records is not None:
        out = target.step()
        transfers = list(target.records)
    elif target.profile and device is not None and device.type == "cuda":
        box = {}
        events, _ = traced_window(expected.label or "audit",
                                  lambda: box.__setitem__("out", target.step()), log=log)
        out, transfers, profiled = box.get("out"), transfers_from_trace(events), True
    else:
        out = target.step()
        transfers = []
    out = out or {}

    violations: list[AuditViolation] = []
    aliases: list[LeafAlias] = []
    role_bytes: dict[str, float] = {}
    expected_n = materialized = 0
    for exp in expected.roles:
        root = exp.arg_root
        leaves, p0 = before[root], ptrs[root]
        role_bytes[exp.role] = float(sum(map(_nbytes, leaves)))
        returned = ([t for t in tree_leaves(out[root]) if isinstance(t, torch.Tensor)]
                    if root in out else leaves)
        for i, t in enumerate(leaves):
            label = f"{root}[{i}] {tuple(t.shape)} {str(t.dtype).replace('torch.', '')}"
            kept = _ptr(t) == p0[i]
            if exp.donate:
                expected_n += 1
                back = returned[i] if i < len(returned) else None
                if kept and back is not None and _ptr(back) == p0[i]:
                    materialized += 1
                    aliases.append(LeafAlias(root, i, _nbytes(t)))
                else:
                    violations.append(AuditViolation(
                        kind="missed-donation", severity="error", op=label,
                        nbytes=float(_nbytes(t)), tier_edge="hbm",
                        planner_term=exp.planner_term,
                        detail=(f"role {exp.role!r} may be updated in place but the step "
                                f"handed it back in new storage: every dispatch pays a "
                                f"silent {_nbytes(t)}-byte copy the planner never priced"),
                    ))
                continue
            written = (exp.arg_root in stamps and _stamp(t) != stamps[root][i])
            if not kept or written:
                what = ("replaced its storage" if not kept
                        else "wrote it in place")
                violations.append(AuditViolation(
                    kind="forbidden-donation", severity="error", op=label,
                    nbytes=float(_nbytes(t)), tier_edge="hbm",
                    planner_term=exp.planner_term,
                    detail=(f"role {exp.role!r} may not be updated by the step (a STREAM "
                            f"placement's source, or read-only), but the step {what}"),
                ))
        if exp.plan_bytes is not None and exp.plan_bytes > 0:
            observed = role_bytes[exp.role]
            rel = abs(observed - exp.plan_bytes) / exp.plan_bytes
            if rel > exp.tolerance:
                violations.append(AuditViolation(
                    kind="byte-plan-mismatch", severity="warning", op=f"role:{exp.role}",
                    nbytes=observed, tier_edge=exp.planner_term,
                    planner_term=exp.planner_term,
                    detail=(f"planner prices {exp.plan_bytes:.0f} B/step for role "
                            f"{exp.role!r} but the step holds {observed:.0f} B ({rel:.0%} "
                            f"off, tolerance {exp.tolerance:.0%})"),
                ))

    host_bytes = float(sum(t.nbytes for t in transfers if t.crosses_host))
    if host_bytes > expected.host_bytes_allowed:
        for t in transfers:
            if not t.crosses_host:
                continue
            violations.append(AuditViolation(
                kind="stray-host-transfer", severity="error", op=f"{t.opcode}",
                nbytes=t.nbytes, tier_edge="host<->hbm", planner_term="pcie",
                detail=(f"host<->device copies are {host_bytes:.0f} B/dispatch, over the "
                        f"policy allowance of {expected.host_bytes_allowed:.0f} B"),
            ))

    return AuditReport(
        label=expected.label, violations=violations, transfers=transfers,
        aliases=aliases, role_bytes=role_bytes, host_transfer_bytes=host_bytes,
        donation_expected=expected_n, donation_materialized=materialized,
        profiled=profiled,
    )
