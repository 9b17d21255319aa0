"""``repro_torch.api`` — the placement-aware runtime facade on one device.

Counterpart of ``repro/api.py``: a :class:`Runtime` owns the device, the
placement policy and the planner.  :meth:`Runtime.auto` runs the planner
restricted to the tiers this device realizes; :meth:`Runtime.realize`
places a role's tree; :meth:`Runtime.explain` shows the planner's
prediction table; :meth:`Runtime.migrate` moves live tensors between
tiers; :meth:`Runtime.open_stream` stages a host-resident stack window by
window (:class:`~repro_torch.core.placement.HostStream`).

One card plays the part of the reference's one-device mesh, with one
difference: the reference's ``mesh=None`` realizes nothing
(``api.py:294-299`` of the reference), while a card realizes its two
local tiers, its own memory and pinned host memory.  Peer and remote
tiers need a donor axis one card does not have, so a policy that places a
role there raises :class:`~repro_torch.core.placement.DonorAxisError` at
construction, never a silent local landing.  On the CPU host memory *is*
the device's memory: the planner offers no host policy there
(:func:`~repro_torch.core.placement.host_available` is False), but a
forced one runs, its host copy in plain memory, so the streaming logic is
exercised by the CPU tests.

Tier loss and faults (ported with ROADMAP A11): :attr:`Runtime.faults` is the
injected-fault schedule (:data:`~repro_torch.core.faults.NO_FAULTS` by
default) whose ``realize`` and ``migrate`` sites these entry points
check, and :meth:`Runtime.evacuate` abandons a lost tier.  On one card it
really moves a role off a lost ``host`` tier into the card's memory,
where the reference's ``mesh=None`` returns ``[]``.

Data-movement audit (ported with ROADMAP A12): :meth:`Runtime.audit`
runs a step once and holds what it did against this policy — caches
written in place, read-only and streamed roles left alone, and, with the
profiler on a card, its host<->device copy records within the allowance
(:mod:`repro_torch.analysis.transfer_audit`).  Where the reference reads
a compiled module's text, its ``target`` is a step callable with its role
trees.

Not ported, each named in ROADMAP: ``rules`` (A10), ``specs`` (shardings
need a mesh, A10).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Iterable, Mapping

import torch

from repro_torch import resolve_device
from repro_torch.configs import ShapeSpec
from repro_torch.core.datapath import copy_bound
from repro_torch.core.faults import NO_FAULTS
from repro_torch.core.hardware import (
    MemoryTier,
    SystemSpec,
    get_active_system,
    set_active_system,
)
from repro_torch.core.placement import (
    HostStream,
    Placement,
    PlacementPolicy,
    Role,
    Strategy,
    donation_compatible,
    donor_allow_flags,
    get_policy,
    parse_policy,
    parse_role,
    parse_tier,
    place_tree,
    registered_policies,
    validate_policy_for_mesh,
)
from repro_torch.core.planner import (
    PlacementOOMError,
    PolicyPrediction,
    plan,
    predict,
)
from repro_torch.core.replay import ReplayLog
from repro_torch.models.sharding import tree_leaves

log = logging.getLogger("repro_torch.api")

__all__ = ["Runtime", "PhasePlan"]

#: decode-step EWMA weights (old, new), the reference's
_EWMA_OLD, _EWMA_NEW = 0.8, 0.2

#: tiers lost together (one donor axis carries both)
_PEER_TIERS = frozenset({MemoryTier.PEER_HBM, MemoryTier.PEER_HOST})
_REMOTE_TIERS = frozenset({MemoryTier.REMOTE_HBM})


@dataclasses.dataclass
class PhasePlan:
    """One planner pass: the pick plus everything it was compared against.

    ``predictions`` maps policy name to the phase's (possibly combined)
    :class:`~repro_torch.core.planner.PolicyPrediction`; ``score`` is the
    quantity the pick minimized (plain ``step_s`` for single-profile
    phases, the combined per-token time for ``serve``).
    """

    phase: str
    picked: str
    predictions: dict[str, PolicyPrediction]
    score: dict[str, float]
    feasible: frozenset[str]

    def table(self, top: int = 3) -> str:
        """Human-readable top-``top`` candidate table (the pick always
        included), feasible candidates first, fastest first."""
        ranked = sorted(
            self.predictions,
            key=lambda n: (n not in self.feasible, self.score[n]),
        )
        show = ranked[:top]
        if self.picked in self.predictions and self.picked not in show:
            show.append(self.picked)
        lines = [f"phase={self.phase} picked={self.picked}"]
        for name in show:
            mark = "=> " if name == self.picked else "   "
            lines.append(f"{mark}{self.predictions[name].explain()}")
        return "\n".join(lines)


def _resolve_candidates(candidates) -> list[PlacementPolicy] | None:
    if candidates is None:
        return None
    return [parse_policy(c) for c in candidates]


def _candidate_index(cand: list[PlacementPolicy] | None) -> dict[str, PlacementPolicy]:
    """Name -> policy over the candidate set the planner enumerated (the
    registry when no explicit candidates were given)."""
    return {
        p.name: p
        for p in (registered_policies().values() if cand is None else cand)
    }


class Runtime:
    """Device + placement policy + planner behind one object.

    Construct directly to force a policy (any
    :func:`~repro_torch.core.placement.parse_policy` spelling, or a
    :class:`~repro_torch.core.placement.PlacementPolicy` value), or via
    :meth:`auto` to let the planner pick for a phase.  ``bundle`` is a
    :class:`~repro_torch.models.model_zoo.ModelSizing` (or a bundle).
    ``device`` defaults to ``cuda``.
    """

    def __init__(
        self,
        bundle,
        device: str | torch.device | None = None,
        policy: PlacementPolicy | str | Mapping | None = None,
        *,
        system: SystemSpec | None = None,
    ):
        self.bundle = bundle
        self.device = resolve_device(device)
        # the runtime owns the (possibly calibrated) system every pricing
        # path consumes; None adopts the process-wide active system
        self.system = system if system is not None else get_active_system()
        self.policy = (
            get_policy("hbm_resident") if policy is None else parse_policy(policy)
        )
        # a peer/remote placement needs a donor axis: refused up front
        validate_policy_for_mesh(self.policy, None)
        #: planner passes run by auto()/plan_phase(), newest per phase
        self.plans: dict[str, PhasePlan] = {}
        self._streams: dict[Role, tuple[HostStream, tuple]] = {}
        self._step_estimates: dict[tuple, float] = {}
        #: measured decode-step EWMA per (batch_slots, max_len, policy)
        self._step_observed: dict[tuple, float] = {}
        #: the last Calibration adopted by calibrate() (None = spec)
        self.calibration = None
        #: predicted-vs-measured log fed by observe_decode_step()
        self.replay = ReplayLog()
        #: tiers declared unusable by mark_tier_lost()
        self.lost_tiers: set[MemoryTier] = set()
        #: injected-fault schedule (core.faults.FaultPlan) every site of
        #: this runtime and its Executor consults; NO_FAULTS costs one
        #: truthiness test per site
        self.faults = NO_FAULTS

    # -- construction ------------------------------------------------------
    @classmethod
    def auto(
        cls,
        bundle,
        device: str | torch.device | None = None,
        *,
        phase: str = "decode",
        system: SystemSpec | None = None,
        candidates: Iterable[PlacementPolicy | str] | None = None,
        require_fit: bool = False,
        **phase_kw,
    ) -> "Runtime":
        """Planner-selected Runtime for ``phase`` (``"train"``,
        ``"decode"``, ``"prefill"`` or ``"serve"``); ``phase_kw`` are the
        workload knobs of :meth:`plan_phase`.  The candidate set defaults
        to the registry restricted to the tiers this device realizes."""
        rt = cls(bundle, device, None, system=system)
        rt.plan_phase(phase, candidates=candidates, require_fit=require_fit,
                      **phase_kw)
        return rt

    # -- degraded-tier bookkeeping -----------------------------------------
    def mark_tier_lost(self, tier: "MemoryTier | str") -> MemoryTier:
        """Declare ``tier`` unusable for the rest of this runtime's life
        (with its donor-axis sibling); every later planner pass and spill
        pick excludes it (:meth:`_allow_flags`)."""
        tier = parse_tier(tier)
        self.lost_tiers.add(tier)
        if tier in _PEER_TIERS:
            self.lost_tiers |= _PEER_TIERS
        if tier in _REMOTE_TIERS:
            self.lost_tiers |= _REMOTE_TIERS
        log.warning("tier %s marked lost (now excluded: %s)", tier.value,
                    sorted(t.value for t in self.lost_tiers))
        return tier

    def _allow_flags(self) -> dict:
        """``donor_allow_flags`` for this device, masked by
        :attr:`lost_tiers`: the one place every planning and spill path
        gets its tier eligibility."""
        allow = donor_allow_flags(None, self.device)
        if not self.lost_tiers:
            return allow
        allow = dict(allow)
        if MemoryTier.HOST in self.lost_tiers:
            allow["allow_host"] = False
        if self.lost_tiers & _PEER_TIERS:
            allow["allow_peer"] = False
        if self.lost_tiers & _REMOTE_TIERS:
            allow["allow_remote"] = False
        return allow

    # -- planning ----------------------------------------------------------
    def plan_phase(
        self,
        phase: str = "decode",
        *,
        batch: int = 8,
        seq: int = 128,
        remat: bool = True,
        batch_slots: int = 8,
        max_len: int = 512,
        prefill_chunk: int = 32,
        kv_utilization: float = 1.0,
        candidates: Iterable[PlacementPolicy | str] | None = None,
        require_fit: bool = False,
        log_table: bool = True,
    ) -> PolicyPrediction:
        """Run the planner for ``phase`` and adopt its pick.

        Restricted to the tiers this runtime realizes; ``kv_utilization``
        scales the serve-side profiles' KV-cache bytes to the current
        occupancy.  Returns the winning (decode-side for ``serve``)
        prediction; the full comparison lands in :attr:`plans`.
        """
        cand = _resolve_candidates(candidates)
        allow = self._allow_flags()
        if phase == "train":
            prof = self.bundle.train_workload(
                ShapeSpec("auto", seq, batch, "train"), num_chips=1,
                data_axis_size=1, pod_axis_size=1, remat=remat,
            )
            best, preds = plan(prof, cand, self.system, require_fit=require_fit,
                               **allow)
            score = {p.policy: p.step_s for p in preds}
            combined = {p.policy: p for p in preds}
        elif phase in ("decode", "prefill"):
            shape = ShapeSpec("auto", max_len, batch_slots, "decode")
            if phase == "decode":
                prof = self.bundle.decode_workload(shape, num_chips=1)
            else:
                prof = self.bundle.prefill_workload(
                    shape, chunk_tokens=prefill_chunk, num_chips=1)
            prof = _scale_kv(prof, kv_utilization)
            best, preds = plan(prof, cand, self.system, require_fit=require_fit,
                               **allow)
            score = {p.policy: p.step_s for p in preds}
            combined = {p.policy: p for p in preds}
        elif phase == "serve":
            best, score, combined = self._plan_serve(
                cand, batch_slots=batch_slots, max_len=max_len,
                prefill_chunk=prefill_chunk, kv_utilization=kv_utilization,
                require_fit=require_fit,
            )
        else:
            raise ValueError(
                f"unknown phase {phase!r}; one of train/decode/prefill/serve")

        self.policy = _candidate_index(cand)[best.policy]
        self.plans[phase] = PhasePlan(
            phase=phase, picked=best.policy, predictions=combined, score=score,
            feasible=frozenset(n for n, p in combined.items() if p.fits),
        )
        if log_table:
            log.info("planner\n%s", self.explain(phase))
        return best

    def _plan_serve(self, cand, *, batch_slots: int, max_len: int,
                    prefill_chunk: int, kv_utilization: float, require_fit: bool):
        """Price decode AND chunked prefill; minimize the combined
        per-token time over policies that fit both phases (one decode step
        yields ``batch_slots`` tokens, one prefill dispatch ingests
        ``batch_slots * prefill_chunk``).  When nothing fits, the
        least-HBM decode prediction, unless ``require_fit``."""
        shape = ShapeSpec("serve", max_len, batch_slots, "decode")
        dec_prof = _scale_kv(self.bundle.decode_workload(shape, num_chips=1),
                             kv_utilization)
        pre_prof = _scale_kv(
            self.bundle.prefill_workload(shape, chunk_tokens=prefill_chunk,
                                         num_chips=1),
            kv_utilization,
        )
        _, dec_preds = plan(dec_prof, cand, self.system, **self._allow_flags())
        by_name = _candidate_index(cand)
        pre_preds = {
            d.policy: predict(pre_prof, by_name[d.policy], self.system)
            for d in dec_preds
        }

        def per_token(d: PolicyPrediction) -> float:
            return d.step_s + pre_preds[d.policy].step_s / max(prefill_chunk, 1)

        score = {d.policy: per_token(d) for d in dec_preds}
        feasible = [d for d in dec_preds if d.fits and pre_preds[d.policy].fits]
        if feasible:
            best = min(feasible, key=per_token)
        elif require_fit:
            raise PlacementOOMError(dec_preds, self.system)
        else:
            best = min(dec_preds, key=lambda d: d.hbm_bytes)
            for d in dec_preds:
                log.warning(
                    "planner OOM: %s overflows pools %s (decode) / %s (prefill)",
                    d.policy, ", ".join(d.overflow_pools) or "none",
                    ", ".join(pre_preds[d.policy].overflow_pools) or "none")
        # serve feasibility is the fit of BOTH phases
        combined = {
            d.policy: dataclasses.replace(d, fits=d.fits and pre_preds[d.policy].fits)
            for d in dec_preds
        }
        return best, score, combined

    def explain(self, phase: str | None = None, top: int = 3) -> str:
        """The planner's prediction table for ``phase`` (default: every
        phase planned so far); empty when nothing was planned."""
        plans = (list(self.plans.values()) if phase is None
                 else [self.plans[phase]] if phase in self.plans else [])
        return "\n".join(pl.table(top) for pl in plans)

    def describe(self) -> dict:
        """JSON-serializable record of what this runtime runs under."""
        return {
            "policy": json.loads(self.policy.to_json()),
            "mesh_axes": None,
            "device": str(self.device),
            "phases": {
                name: {"picked": pl.picked, "top3": pl.table(3)}
                for name, pl in self.plans.items()
            },
        }

    # -- realization -------------------------------------------------------
    def realize(self, tree, role: Role | str, *, policy: PlacementPolicy | None = None):
        """``tree`` under the policy's placement of ``role``
        (:func:`~repro_torch.core.placement.place_tree`): this device's
        memory under ``HBM``; under ``HOST`` a pinned host arena, whose
        leaves on a card are CUDA tensors over its mapped view for a
        RESIDENT placement (the steps compute on them in place, over PCIe)
        and the pinned host tensors themselves for a STREAM one (staged
        window by window).  A tree already where the placement puts it is
        returned as it is (no copy)."""
        if self.faults:
            self.faults.check("realize")
        pl = (policy or self.policy).placement(parse_role(role))
        leaves = tree_leaves(tree)
        # "cuda" is the current card: a tensor there reports its index
        here = (torch.device("cuda", torch.cuda.current_device())
                if self.device.type == "cuda" and self.device.index is None else self.device)
        if pl.tier is MemoryTier.HBM and all(t.device == here for t in leaves):
            return tree
        if pl.tier is MemoryTier.HOST:
            # a mapped view lies on the card, a streamed leaf on the CPU
            where = (self.device if pl.strategy is Strategy.RESIDENT
                     else torch.device("cpu"))
            if all(getattr(t, "_host_arena", None) is not None
                   and t._host_arena.device == self.device
                   and t.device.type == where.type for t in leaves):
                return tree
        return place_tree(tree, pl, self.device)

    def streamed(self, role: Role | str) -> bool:
        """Does a step compute on ``role`` through staged windows (a
        ``host:stream`` placement: :class:`HostStream` copies each window
        to the card and back)?  False for a RESIDENT host placement, which
        the steps read and write in place (on a card through its mapped
        view, over PCIe), and for ``HBM``."""
        pl = self.policy.placement(parse_role(role))
        return pl.on_host and pl.strategy is Strategy.STREAM

    def donate_ok(self, role: Role | str) -> bool:
        """May a step update ``role``'s buffers in place under the current
        policy?  (A STREAM placement keeps its host copy as the source.)"""
        return donation_compatible(self.policy, parse_role(role))

    # -- data-movement audit -----------------------------------------------
    def audit(
        self,
        target,
        arg_roles: Mapping[str, "Role | str"],
        *,
        donated: Iterable[str] = (),
        host_bytes_allowed: float = 0.0,
        workload=None,
        tolerance: float = 0.5,
        label: str = "",
    ):
        """Run a step once and diff its data movement against this policy.

        ``target`` is a :class:`~repro_torch.analysis.transfer_audit.
        StepTarget`: ``step()`` runs the step and returns the role trees it
        hands back, ``trees`` maps each tree's name to the tree.  ``arg_roles`` maps those names to planner roles
        (``{"caches": Role.KV_CACHE, "p": Role.PARAMS}``); ``donated`` names
        the trees the step writes.  A written tree whose placement allows
        it must come back in its own storage (else ``missed-donation``); a
        tree whose placement streams it keeps its storage, and one the step
        does not write stays unwritten (else ``forbidden-donation``); the
        KV write-back into a streamed cache is the placement's own write.
        With ``target.profile`` on a card the step runs inside a traced
        window and its host<->device copy records beyond
        ``host_bytes_allowed`` are ``stray-host-transfer``.  With a planner
        ``workload``, each role's bytes are also held to its
        ``bytes_per_role`` within ``tolerance`` (a warning).

        Returns a :class:`~repro_torch.analysis.transfer_audit.AuditReport`.
        """
        from repro_torch.analysis.transfer_audit import (
            ExpectedMovement,
            RoleExpectation,
            audit_step,
        )

        donated = set(donated)
        plan_bytes = dict(getattr(workload, "bytes_per_role", None) or {})
        term_by_tier = {
            MemoryTier.HBM: "hbm",
            MemoryTier.HOST: "pcie",
            MemoryTier.PEER_HBM: "ici",
            MemoryTier.PEER_HOST: "ici",
            MemoryTier.REMOTE_HBM: "dcn",
        }
        roles = []
        for root, role in arg_roles.items():
            role = parse_role(role)
            roles.append(RoleExpectation(
                role=role.value,
                arg_root=root,
                donate=root in donated and self.donate_ok(role),
                planner_term=term_by_tier.get(self.policy.placement(role).tier, "hbm"),
                plan_bytes=float(plan_bytes[role]) if role in plan_bytes else None,
                tolerance=tolerance,
                placement_writes=root in donated and not self.donate_ok(role),
            ))
        expected = ExpectedMovement(
            roles=tuple(roles),
            host_bytes_allowed=float(host_bytes_allowed),
            label=label or f"{self.bundle.cfg.name}:{self.policy.name}",
        )
        return audit_step(target, expected, self.device)

    # -- eviction pricing --------------------------------------------------
    def price_copy(self, nbytes: float, dst: "Placement | MemoryTier | str",
                   src: "Placement | MemoryTier | str | None" = None) -> float:
        """Planner-priced seconds to move ``nbytes`` from ``src`` (default:
        the current policy's KV-cache tier) to ``dst``: the datapath
        ``copy_bound``."""
        if src is None:
            src = self.policy.placement(Role.KV_CACHE)
        src_t = src.tier if isinstance(src, Placement) else parse_tier(src)
        dst_t = dst.tier if isinstance(dst, Placement) else parse_tier(dst)
        return copy_bound(src_t, dst_t, self.system).time(nbytes)

    def spill_placement(self, allow: dict | None = None) -> Placement:
        """The cheapest realizable far-tier parking spot for evicted KV
        rows (host memory on a card); local HBM when no far tier is
        realizable.  ``allow`` pins one ``_allow_flags()`` snapshot."""
        if allow is None:
            allow = self._allow_flags()
        tiers: list[MemoryTier] = []
        if allow["allow_host"]:
            tiers.append(MemoryTier.HOST)
        if allow["allow_peer"]:
            tiers += [MemoryTier.PEER_HOST, MemoryTier.PEER_HBM]
        if allow["allow_remote"]:
            tiers.append(MemoryTier.REMOTE_HBM)
        if not tiers:
            return Placement(MemoryTier.HBM)
        one_mb = 1 << 20   # round trip at a representative row size
        best = min(
            tiers,
            key=lambda t: self.price_copy(one_mb, t) + self.price_copy(
                one_mb, self.policy.placement(Role.KV_CACHE), src=t),
        )
        return Placement(best)

    def preemption_price(self, nbytes: float) -> tuple[Placement, float]:
        """(spill placement, round-trip seconds) for parking ``nbytes`` of
        KV rows off-cache and bringing them back; the pick and the price
        read one ``_allow_flags()`` snapshot."""
        allow = self._allow_flags()
        spill = self.spill_placement(allow=allow)
        kv = self.policy.placement(Role.KV_CACHE)
        return spill, (self.price_copy(nbytes, spill)
                       + self.price_copy(nbytes, kv, src=spill))

    def decode_step_seconds(self, batch_slots: int, max_len: int) -> float:
        """Decode-step seconds under the current policy: the observed EWMA
        once :meth:`observe_decode_step` has fed this shape, the planner's
        prediction before."""
        observed = self.measured_step_s(batch_slots, max_len)
        if observed is not None:
            return observed
        return self._analytic_step_seconds(batch_slots, max_len)

    def _analytic_step_seconds(self, batch_slots: int, max_len: int) -> float:
        key = (batch_slots, max_len, self.policy.name)
        cached = self._step_estimates.get(key)
        if cached is not None:
            return cached
        prof = self.bundle.decode_workload(
            ShapeSpec("serve", max_len, batch_slots, "decode"), num_chips=1)
        est = predict(prof, self.policy, self.system).step_s
        self._step_estimates[key] = est
        return est

    def measured_step_s(self, batch_slots: int, max_len: int) -> float | None:
        """The observed decode-step EWMA for this shape under the current
        policy, or None before any observation."""
        return self._step_observed.get((batch_slots, max_len, self.policy.name))

    def observe_decode_step(self, batch_slots: int, max_len: int,
                            seconds: float) -> float:
        """Feed one measured decode-step time: updates the EWMA
        :meth:`decode_step_seconds` returns and logs predicted against
        measured into :attr:`replay`.  Returns the updated EWMA."""
        seconds = float(seconds)
        if seconds <= 0.0:
            return self.decode_step_seconds(batch_slots, max_len)
        key = (batch_slots, max_len, self.policy.name)
        prev = self._step_observed.get(key)
        ewma = seconds if prev is None else _EWMA_OLD * prev + _EWMA_NEW * seconds
        self._step_observed[key] = ewma
        self.replay.record(
            "decode_step", f"decode[{self.policy.name},b{batch_slots},l{max_len}]",
            self._analytic_step_seconds(batch_slots, max_len), seconds,
            source="executor",
        )
        return ewma

    # -- calibration -------------------------------------------------------
    def calibrate(self, path=None, *, activate: bool = True, **kwargs):
        """Adopt a measurement-calibrated system for every pricing path:
        load ``calibration.json`` at ``path``, or calibrate on this device
        and save it there.  ``activate`` also installs it process-wide.
        Calibration changes pricing only, never realized placements or
        computed values.  Returns the
        :class:`~repro_torch.core.calibration.Calibration`."""
        from repro_torch.core.calibration import load_or_calibrate

        kwargs.setdefault("device", self.device)
        cal = load_or_calibrate(path, system=self.system, **kwargs)
        self.calibration = cal
        self.system = cal.apply(self.system)
        if activate:
            set_active_system(self.system)
        self._step_estimates.clear()
        self.replay.extend(cal.replay.records())
        log.info("calibrated hardware model:\n%s", cal.summary())
        return cal

    # -- live migration ----------------------------------------------------
    def migrate(self, tree, role: Role | str,
                to_policy: "PlacementPolicy | str | Mapping | Placement"):
        """Re-place ``role``'s live tree under ``to_policy`` (any
        ``parse_policy`` spelling, or a bare :class:`Placement` applied to
        ``role`` on top of the current policy): a copy into pinned host
        memory or into this device's memory, value for value.  A peer or
        remote target raises :class:`DonorAxisError` first.  Adopts the
        new policy, rebuilds ``role``'s open stream around the moved tree,
        and returns it; the caller drops the old tree to free it.  An
        injected ``migrate`` fault fires before anything moves or is
        adopted, so a retry sees the exact state before the call."""
        if self.faults:
            self.faults.check("migrate")
        role = parse_role(role)
        if isinstance(to_policy, Placement):
            new_policy = self.policy.with_placement(role, to_policy).renamed(
                f"{self.policy.name}+{role.value}={to_policy.to_str()}")
        else:
            new_policy = parse_policy(to_policy)
        validate_policy_for_mesh(new_policy, None)
        moved = place_tree(tree, new_policy.placement(role), self.device)
        old = self.policy.placement(role)
        self.policy = new_policy
        self._rebuild_stream(role, moved)
        log.info("migrated %s: %s -> %s under policy %s", role.value,
                 old.to_str(), new_policy.placement(role).to_str(), new_policy.name)
        return moved

    def migrate_roles(self, trees: dict, target: "PlacementPolicy | str | Mapping", *,
                      force: bool = False) -> list[Role]:
        """Migrate several roles' live trees to ``target`` in one pass.

        ``trees`` maps roles to live trees and is updated **in place** as
        each role lands, so a moved tree survives a later role's failure.
        Roles whose placement is unchanged are skipped unless ``force``.
        On partial failure the adopted policy is the old one with the
        moved placements swapped in (it always describes where the live
        buffers are) and the error re-raises; on success ``target`` is
        adopted.  Returns the roles moved.
        """
        target = parse_policy(target)
        validate_policy_for_mesh(target, None)
        old = self.policy
        moved: list[Role] = []
        try:
            for key in list(trees):
                role = parse_role(key)
                if not force and target.placement(role) == old.placement(role):
                    continue
                trees[key] = self.migrate(trees[key], role, target)
                # hold the handover until every role lands
                self.policy = old
                moved.append(role)
        except BaseException:
            partial = old
            for r in moved:
                partial = partial.with_placement(r, target.placement(r))
            if moved:
                partial = partial.renamed(old.name + "+" + ",".join(
                    f"{r.value}={target.placement(r).to_str()}" for r in moved))
            self.policy = partial
            raise
        self.policy = target
        return moved

    def evacuate(self, tier: "MemoryTier | str", trees: dict, *,
                 phase: str | None = None, **phase_kw) -> tuple[PlacementPolicy, list[Role]]:
        """Abandon ``tier`` and re-place every affected role off it.

        :meth:`mark_tier_lost` excludes the tier from every later planner
        pass and spill pick; then the roles in ``trees`` whose placement
        sits on a lost tier migrate to a realizable target — the
        planner's re-pick for ``phase`` when given (``phase_kw`` are
        :meth:`plan_phase`'s knobs), else the current policy with each
        lost placement swapped to the device's memory.  Reuses
        :meth:`migrate_roles`' semantics (``trees`` updated in place as
        roles land; the adopted policy describes the live buffers on a
        partial failure).  The lost tier's buffers are assumed still
        readable (a degradation notice, not data loss), so the evacuation
        copy reads them one last time.  Returns ``(adopted policy, roles
        moved)``."""
        tier = self.mark_tier_lost(tier)
        old = self.policy
        affected = [r for r in trees
                    if old.placement(parse_role(r)).tier in self.lost_tiers]
        if not affected:
            return old, []
        target = None
        if phase is not None:
            try:
                self.plan_phase(phase, log_table=False, **phase_kw)
                target = self.policy
            finally:
                self.policy = old
            # the planner minimizes step time, not realizability of the
            # degraded set: guard against a pick still on a lost tier
            if any(target.placement(parse_role(r)).tier in self.lost_tiers
                   for r in trees):
                target = None
        if target is None:
            target = old
            for r, p in old.placements.items():
                if p.tier in self.lost_tiers:
                    target = target.with_placement(r, Placement(MemoryTier.HBM))
            target = target.renamed(f"{old.name}-evac-{tier.value}")
        moved = self.migrate_roles(trees, target)
        log.warning("evacuated %s off %s: policy %s -> %s",
                    ",".join(r.value for r in moved) or "nothing",
                    tier.value, old.name, self.policy.name)
        return self.policy, moved

    # -- streaming ---------------------------------------------------------
    def open_stream(self, tree, role: Role | str, n_windows: int, *,
                    depth: int = 2) -> HostStream:
        """Double-buffered window streamer over ``role``'s host-resident
        stack (dim 0), registered so :meth:`migrate` rebuilds it around
        the migrated tree."""
        role = parse_role(role)
        stream = HostStream.stacked(tree, n_windows, self.device, depth)
        self._streams[role] = (stream, (n_windows, depth))
        return stream

    def stream(self, role: Role | str) -> HostStream | None:
        """The registered stream for ``role`` (None when none is open)."""
        entry = self._streams.get(parse_role(role))
        return entry[0] if entry else None

    def _rebuild_stream(self, role: Role, tree) -> None:
        """Re-open ``role``'s stream over its migrated tree; a role that
        left host memory, or stays there RESIDENT, has nothing to stream,
        and its stream closes."""
        entry = self._streams.get(role)
        if entry is None:
            return
        if not self.policy.placement(role).on_host:
            del self._streams[role]
            return
        if not self.streamed(role):        # RESIDENT: nothing is staged
            del self._streams[role]
            return
        n_windows, depth = entry[1]
        self._streams[role] = (
            HostStream.stacked(tree, n_windows, self.device, depth),
            (n_windows, depth),
        )


def _scale_kv(profile, utilization: float):
    """Scale a profile's KV-cache bytes to the live cache occupancy,
    clamped to [1/16, 1]."""
    u = min(max(float(utilization), 1.0 / 16.0), 1.0)
    if u >= 1.0 or Role.KV_CACHE not in profile.bytes_per_role:
        return profile
    scaled = dict(profile.bytes_per_role)
    scaled[Role.KV_CACHE] = scaled[Role.KV_CACHE] * u
    return dataclasses.replace(profile, bytes_per_role=scaled)
