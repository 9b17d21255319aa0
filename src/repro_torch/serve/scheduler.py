"""Scheduler: the continuous-batching front end of the serve stack.

Counterpart of ``repro/serve/scheduler.py``.  This layer owns *requests*:
a bounded wait queue with FIFO-by-wait-start admission, batched chunked
prefill of newly admitted requests while other rows keep decoding,
streaming per-token callbacks, planner-priced preemption, cancellation
and deadlines, live re-placement, fault recovery and the step watchdog —
behind the public :class:`Server` — plus an asyncio front end
(:class:`Scheduler`) for callers that want ``await submit()`` / ``async
for token in stream()``.

Request lifecycle::

            submit/add_request          admit (FIFO by wait start)
    new ───────────────────────▶ queued ─────────────▶ active (decode)
             QueueFullError when            ▲                 │
             cfg.max_queue waiting          │ promote         │ preempt
                                            │ (slot frees)    ▼
                                         spilled ◀──── cache rows parked on
                                                       the planner-priced
                                                       spill tier; re-queued

    active ──▶ done: stop token | max_new_tokens | cache extent |
               cancel() | deadline_s; slot freed, mirrors re-synced

**Planner-priced preemption** (the paper's §IV decision made per slot at
run time): when the oldest waiter has starved for ``preempt_wait`` ticks
and no slot is free, the scheduler asks the runtime what eviction costs
(``Runtime.preemption_price``: the round trip of one slot's rows to the
cheapest realizable far tier — pinned host memory on a card — through
the datapath ``copy_bound``) and what waiting costs (the measured-else-
predicted decode step times the fewest remaining tokens of any active
request).  Only when spilling is cheaper does it evict the active
request with the most remaining work.  Its rows are copied out of the
captured cache buffers and back into a free slot of the same buffers on
promotion, so greedy tokens are invariant under any preemption history
and no graph is captured again.

**Recovery**: a :class:`~repro_torch.core.faults.TierLossError` evacuates
the lost tier (the steps rebuilt over the moved trees) and replays what
was parked there; a corrupted spill replays its request.  A replay
prefills the request's prompt as its first admission did and then
decodes its generated tokens again, without emitting them, each checked
against the one emitted before: the same kernels at the same positions,
so the continuation is the uninterrupted one bit for bit, in any dtype
(the reference prefills prompt + generated tokens, which its float32
smoke runs make equal; a bfloat16 prefill on the card is not the decode
step's arithmetic).  The
:class:`~repro_torch.runtime.supervisor.Watchdog` deadlines each decode
step and escalates stall → retry (recapture) → evacuate → hang.

Placement: ``ServeConfig.policy`` forces a placement policy, or leaves
the pick to the planner; the :class:`Executor` realizes it through its
:class:`~repro_torch.api.Runtime` (``server.runtime``).

``ServeConfig.verify_donation`` (ported with ROADMAP A12) raises where
an ``Executor`` build's movement audit finds the cache copied instead of
written in place, or the params or a streamed source written: at the
build on a card, at the step's first run after it eagerly.

Left out, each named in ROADMAP: ``adopt_spilled``, ``requeue_hook`` and
``ServeConfig.pool`` (disaggregated serving, A13) and ``rules`` (A10).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Callable

import numpy as np

from repro_torch.core.faults import (
    FaultKind,
    FaultPlan,
    SpillCorruptionError,
    TierLossError,
    checksum_tree,
    corrupt_tree,
    verify_spill,
)
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import PlacementPolicy, Role, parse_policy
from repro_torch.runtime.supervisor import Watchdog, WatchdogConfig
from repro_torch.serve.engine import Executor
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.state import SlotTable, SpilledSequence

log = logging.getLogger("repro_torch.serve.scheduler")


class QueueFullError(RuntimeError):
    """Backpressure: the bounded wait queue is at ``cfg.max_queue``.

    The sync surface raises so callers can shed or retry;
    :meth:`Scheduler.submit` absorbs it by awaiting queue space instead.
    """


class ServeHangError(RuntimeError):
    """The serve loop failed to make progress: ``run_until_done``
    exhausted its step budget with live requests still queued, or the
    watchdog escalated past its last rung.  Carries the queue depth, the
    live rids, and the last stats snapshot."""

    def __init__(
        self,
        message: str,
        *,
        queue_depth: int = 0,
        live_rids=(),
        stats: dict | None = None,
    ):
        self.queue_depth = int(queue_depth)
        self.live_rids = tuple(live_rids)
        self.stats = dict(stats or {})
        super().__init__(
            f"{message} [queue_depth={self.queue_depth} "
            f"live_rids={list(self.live_rids)} stats={self.stats}]"
        )


class SchedulerClosed(RuntimeError):
    """:meth:`Scheduler.close` was called: pending ``submit()`` waiters
    (and streams that can no longer finish) are cancelled with this
    instead of waiting forever."""


@dataclasses.dataclass
class Request:
    """One generation request.

    ``sampling`` defaults to greedy; ``on_token`` streams each generated
    token as ``on_token(request, token)`` the tick it is decoded (a
    cancelled or expired request streams one terminal ``-1`` with ``done``
    already set).  The ``*_s`` fields are ``time.perf_counter`` stamps.
    ``deadline_s`` bounds the request's *total* wall time from submission:
    past it the server expires the request at the next tick.
    """

    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int
    sampling: SamplingParams = GREEDY
    on_token: Callable[["Request", int], None] | None = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0
    submitted_s: float | None = None
    first_token_s: float | None = None
    finished_s: float | None = None
    #: total wall-time budget from submission (None = unbounded)
    deadline_s: float | None = None
    cancelled: bool = False

    def cancel(self) -> None:
        """Cooperative cancellation: the server finalizes the request on
        its next tick — slot freed, terminal ``-1`` streamed to
        ``on_token``, counted in ``stats()["cancelled"]``.  Idempotent; a
        no-op once done."""
        self.cancelled = True


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 512
    #: tokens per chunked-prefill dispatch during admission
    prefill_chunk: int = 32
    #: None: the planner picks for the serve phase (``Runtime.auto``);
    #: otherwise any ``parse_policy`` spelling — a PlacementPolicy value,
    #: a registered name, ``"kv=host:stream,..."``, or policy JSON.
    policy: PlacementPolicy | str | dict | None = None
    #: re-run the planner (and migrate KV/params if the pick changes)
    #: whenever cache occupancy crosses a band boundary
    auto_replan: bool = False
    #: number of occupancy bands for auto_replan
    replan_bands: int = 4
    #: bound on *waiting* (not yet admitted) requests; None = unbounded.
    #: add_request raises QueueFullError beyond it (spilled sequences do
    #: not count against it).
    max_queue: int | None = None
    #: enable planner-priced preemption (spill a victim's slot rows to the
    #: cheapest realizable far tier when waiters starve)
    preempt: bool = False
    #: ticks the oldest waiter must starve before preemption is
    #: considered — also the thrash guard: a freshly (re)admitted slot
    #: cannot be re-evicted sooner
    preempt_wait: int = 8
    #: raise when an Executor build's movement audit finds the cache
    #: copied instead of written in place, or the params or a streamed
    #: source written (analysis.transfer_audit.DonationAliasError instead
    #: of a silent cache-sized copy per dispatch)
    verify_donation: bool = True
    #: injected-fault schedule (core.faults.FaultPlan); None = NO_FAULTS.
    #: Lives on the executor's Runtime so every site consults one plan.
    faults: FaultPlan | None = None
    #: checksum spilled rows at park time and verify at promotion; a
    #: mismatch drops the parked rows and replays the request.  Always on
    #: while faults are active.
    verify_spills: bool = False
    #: step watchdog (stall -> retry -> evacuate -> ServeHangError); None
    #: disables it.  The deadline follows the runtime's
    #: measured-else-analytic decode-step price.
    watchdog: WatchdogConfig | None = dataclasses.field(
        default_factory=WatchdogConfig
    )

    def __post_init__(self):
        if self.policy is not None:
            self.policy = parse_policy(self.policy)


class Server:
    """Single-model continuous-batching server on one device.

    Composes the scheduler's queue/preemption policy with the
    :class:`Executor` (``server.engine``: params, caches, the device
    state's fixed buffers, the compiled steps, the Runtime) and the
    :class:`SlotTable` (``server.table``).  On the card the steps replay
    CUDA graphs; ``eager=True`` runs them without graphs, to compare the
    two.
    """

    def __init__(self, bundle, cfg: ServeConfig, params, device=None, *,
                 eager: bool = False):
        self.bundle = bundle
        self.cfg = cfg
        self.engine = Executor(bundle, cfg, params, device, eager=eager)
        self.device = self.engine.device
        self.table = SlotTable(cfg.batch_slots)
        self._requests: dict[int, Request] = {}
        #: FIFO by wait start: ("fresh", rid) never yet admitted,
        #: ("spilled", rid) preempted and re-queued
        self._waitq: list[tuple[str, int]] = []
        self._spilled: dict[int, SpilledSequence] = {}
        self._wait_since: dict[int, int] = {}
        self._tick = 0
        self._replan_band: int | None = None
        self._next_rid = 0
        #: rid -> the generated tokens a replayed request (corrupted spill,
        #: tier loss mid-flight) decodes again, unemitted, before it emits
        #: new ones
        self._replaying: dict[int, list[int]] = {}
        self._counters = {
            "preemptions": 0, "promotions": 0, "peak_queue": 0,
            "cancelled": 0, "expired": 0,
            "tier_losses": 0, "spill_corruptions": 0, "requeued_fresh": 0,
            "watchdog_stalls": 0, "watchdog_retries": 0,
            "watchdog_evacuations": 0,
        }
        #: serve-step watchdog over the runtime's measured-else-analytic
        #: step price; None = disabled.  Its closure holds the runtime, not
        #: the server: no reference cycle keeps a dropped server's graphs
        #: for the cyclic collector
        rt = self.engine.runtime
        self.watchdog = (
            None if cfg.watchdog is None
            else Watchdog(
                lambda: rt.decode_step_seconds(cfg.batch_slots, cfg.max_len),
                cfg.watchdog,
            )
        )

    # -- introspection -----------------------------------------------------
    @property
    def params(self):
        return self.engine.params

    @property
    def runtime(self):
        """The executor's :class:`~repro_torch.api.Runtime` (device,
        policy, planner, fault plan)."""
        return self.engine.runtime

    @property
    def policy(self) -> PlacementPolicy:
        """The placement policy in force (may change across
        :meth:`replan` and tier-loss migrations)."""
        return self.engine.policy

    @property
    def queue_depth(self) -> int:
        """Fresh (never admitted) requests waiting — what ``max_queue``
        bounds."""
        return sum(1 for kind, _ in self._waitq if kind == "fresh")

    @property
    def live_rids(self) -> tuple[int, ...]:
        """rids of all live (queued, active, or spilled) requests."""
        return tuple(self._requests)

    def has_work(self) -> bool:
        """Anything queued, spilled, or decoding?"""
        return bool(self._waitq or self._spilled or self.table.active_slots())

    def occupancy(self) -> float:
        """Live cache utilization — what replan pricing feeds the
        planner."""
        return self.table.occupancy(self.cfg.max_len)

    def stats(self) -> dict:
        """Counters across all layers: executor phase tokens/seconds,
        replays, captures and lifecycle events (``replans``/``migrations``/
        ``evacuations``/``migration_retries``/``spill_s``/``restore_s``)
        merged with the scheduler's (``preemptions``/``promotions``/
        ``peak_queue``, ``cancelled``/``expired``/``tier_losses``/
        ``spill_corruptions``/``requeued_fresh``/``watchdog_stalls``/
        ``watchdog_retries``/``watchdog_evacuations``) and the live
        ``queued``/``spilled`` depths."""
        return {
            **self.engine.counters,
            **self._counters,
            "queued": self.queue_depth,
            "spilled": len(self._spilled),
        }

    def throughput(self) -> dict:
        """Prefill/decode split tokens-per-second from the counters."""
        c = self.engine.counters
        return {
            "prefill_tokens": c["prefill_tokens"],
            "decode_tokens": c["decode_tokens"],
            "prefill_tps": (
                c["prefill_tokens"] / c["prefill_s"] if c["prefill_s"]
                else 0.0
            ),
            "decode_tps": (
                c["decode_tokens"] / c["decode_s"] if c["decode_s"]
                else 0.0
            ),
        }

    # -- request intake ----------------------------------------------------
    def add_request(self, req: Request) -> None:
        """Queue a request, validating it against the cache extent.

        When every slot is busy the request waits its turn (and may
        trigger a preemption once it starves past ``preempt_wait``).  The
        only rejections are malformed requests and the bounded-queue
        backpressure (:class:`QueueFullError`) — never a silent drop.
        """
        if req.rid < 0:
            raise ValueError(f"request rid must be >= 0, got {req.rid}")
        if req.rid in self._requests:
            raise ValueError(
                f"request {req.rid}: rid already queued or being served "
                "(rids must be unique among live requests; a duplicate "
                "would orphan the live request's slot bookkeeping — "
                "finished rids are evicted and may be reused)"
            )
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}"
            )
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) >= self.cfg.max_len:
            log.warning(
                "rejecting request %d: prompt of %d tokens needs "
                "len(prompt)+1 cache positions but max_len=%d",
                req.rid, len(req.prompt), self.cfg.max_len,
            )
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"does not fit max_len={self.cfg.max_len} "
                "(need len(prompt) < max_len)"
            )
        req.sampling.validate()
        if (
            self.cfg.max_queue is not None
            and self.queue_depth >= self.cfg.max_queue
        ):
            raise QueueFullError(
                f"request {req.rid}: wait queue is full "
                f"({self.cfg.max_queue} waiting); retry after a slot "
                "drains or raise ServeConfig.max_queue"
            )
        req.submitted_s = time.perf_counter()
        self._requests[req.rid] = req
        self._waitq.append(("fresh", req.rid))
        self._wait_since[req.rid] = self._tick
        self._counters["peak_queue"] = max(
            self._counters["peak_queue"], self.queue_depth
        )

    def add_requests(self, reqs) -> None:
        """Queue several requests at once (they prefill together in the
        next tick's chunked dispatches)."""
        for req in reqs:
            self.add_request(req)

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        sampling: SamplingParams = GREEDY,
        rid: int | None = None,
        on_token: Callable[[Request, int], None] | None = None,
    ) -> Request:
        """Build and queue a request, auto-assigning a free rid."""
        if rid is None:
            while self._next_rid in self._requests:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            sampling=sampling,
            on_token=on_token,
        )
        self.add_request(req)
        return req

    # -- admission / preemption -------------------------------------------
    def _sync_state(self) -> None:
        """Copy the mirrors into the device state's fixed buffers after a
        slot lifecycle event (admission / free / spill / promote).
        Steady-state decode never calls this."""
        self.engine.state.load(self.table)

    def _free_slot(self, i: int) -> int | None:
        """The one place an occupied slot returns to the pool: clears the
        table row and evicts the rid's bookkeeping together."""
        rid = self.table.free(i)
        if rid is not None:
            self._requests.pop(rid, None)
            self._wait_since.pop(rid, None)
            self._replaying.pop(rid, None)
        return rid

    def _requeue_fresh(self, rid: int) -> None:
        """Re-queue a live request as a ``"fresh"`` waiter that replays:
        its next admission prefills its prompt, then it decodes everything
        it generated so far again before emitting anything new.

        The recovery primitive behind corrupted spills and lost spill
        tiers: the decode step is the same arithmetic per row whatever the
        slot and the batch, and sampling draws are (seed,
        position)-deterministic, so the replayed continuation is the
        uninterrupted one.  Inserted at the queue head — the request
        already waited its turn once."""
        req = self._requests[rid]
        if req.out_tokens:
            self._replaying[rid] = list(req.out_tokens)
        else:
            self._replaying.pop(rid, None)
        self._waitq = [(k, r) for k, r in self._waitq if r != rid]
        self._counters["requeued_fresh"] += 1
        self._waitq.insert(0, ("fresh", rid))
        self._wait_since[rid] = self._tick

    def _reap_cancelled_expired(self) -> None:
        """Finalize cancelled and deadline-expired requests (start of
        every tick): slot freed, queue/spill entries dropped, terminal
        ``-1`` streamed, counted in ``stats()["cancelled"]`` /
        ``["expired"]``."""
        now = time.perf_counter()
        freed = False
        for req in list(self._requests.values()):
            if req.done:
                continue
            expired = (
                req.deadline_s is not None
                and req.submitted_s is not None
                and now - req.submitted_s > req.deadline_s
            )
            if not (req.cancelled or expired):
                continue
            why = "cancelled" if req.cancelled else "expired"
            i = self.table.slot_of(req.rid)
            if i is not None:
                self._free_slot(i)
                freed = True
            else:
                self._waitq = [(k, r) for k, r in self._waitq if r != req.rid]
                self._spilled.pop(req.rid, None)
                self._requests.pop(req.rid, None)
                self._wait_since.pop(req.rid, None)
                self._replaying.pop(req.rid, None)
            req.done = True
            req.finished_s = time.perf_counter()
            self._counters[why] += 1
            log.info("request %d %s after %d generated token(s)",
                     req.rid, why, len(req.out_tokens))
            if req.on_token is not None:
                req.on_token(req, -1)
        if freed:
            self._sync_state()

    def _admit(self) -> None:
        """Fill free slots from the wait queue, FIFO by wait start.

        Fresh requests are claimed and prefilled together in one set of
        chunked dispatches; spilled sequences are promoted — their parked
        rows verified (when spill verification is on) and copied back, no
        prefill.  A promotion whose rows fail their integrity check does
        not consume the slot: the rows are dropped and the request replays
        as a fresh waiter.
        """
        free = self.table.free_slots()
        fresh: list[tuple[int, Request, np.ndarray]] = []
        changed = False
        while free and self._waitq:
            kind, rid = self._waitq.pop(0)
            i = free.pop(0)
            changed = True
            if kind == "fresh":
                req = self._requests[rid]
                self.table.claim(i, rid, req.sampling, self._tick)
                fresh.append((i, req, req.prompt))
            else:
                spilled = self._spilled.pop(rid)
                try:
                    self._promote(i, spilled)
                except SpillCorruptionError as e:
                    log.warning("%s", e)
                    self._counters["spill_corruptions"] += 1
                    free.insert(0, i)       # the slot stays free
                    self._requeue_fresh(rid)
        if fresh:
            self.engine.prefill([(i, prompt) for i, _, prompt in fresh], self.table)
            for i, req, prompt in fresh:
                self.table.last_tokens[i, 0] = prompt[-1]
                self.table.active[i] = True
        if changed:
            self._sync_state()

    def _verifying(self) -> bool:
        return bool(self.cfg.verify_spills or self.runtime.faults)

    def _promote(self, i: int, spilled: SpilledSequence) -> None:
        """Copy a spilled sequence's parked rows back into free slot ``i``
        and resume its mirrors.  With verification on, the parked rows are
        first checked against the checksum they had when parked, summed
        where they lie
        (:class:`~repro_torch.core.faults.SpillCorruptionError` on a
        mismatch: nothing is copied and the slot stays free); a record
        without a checksum then cannot be verified and raises."""
        if self._verifying() and spilled.checksum is None:
            raise RuntimeError(
                f"spilled rows for rid {spilled.rid} carry no checksum while "
                "spill verification is on: the promotion cannot be verified")
        if spilled.checksum is not None:
            verify_spill(self.engine.summable(spilled.rows), spilled.checksum,
                         spilled.rid)
        self.engine.insert_slot(i, spilled.rows)
        self.table.resume(i, spilled, self._tick)
        self._wait_since.pop(spilled.rid, None)
        self._counters["promotions"] += 1
        log.info("promoted rid %d into slot %d after %d ticks spilled",
                 spilled.rid, i, self._tick - spilled.since_tick)

    def _remaining(self, i: int) -> int:
        req = self._requests[self.table.slots[i]]
        return max(req.max_new_tokens - len(req.out_tokens), 0)

    def _maybe_preempt(self) -> None:
        """Evict one victim iff the oldest waiter has starved past
        ``preempt_wait`` ticks AND the planner prices the spill round
        trip below the predicted natural wait for a slot."""
        if not self.cfg.preempt or not self._waitq:
            return
        if self.table.free_slots():
            return
        _, head = self._waitq[0]
        if self._tick - self._wait_since.get(head, self._tick) < self.cfg.preempt_wait:
            return
        # thrash guard: never evict a slot that was (re)occupied within
        # the same starvation window
        candidates = [
            i for i in self.table.active_slots()
            if self._tick - int(self.table.claimed_tick[i]) >= self.cfg.preempt_wait
        ]
        if not candidates:
            return
        spill_to, price_s = self.runtime.preemption_price(self.engine.slot_bytes())
        # wait side: the runtime's decode-step price — the measured EWMA
        # once steps have fed it, the planner's prediction before that
        step_s = self.runtime.decode_step_seconds(self.cfg.batch_slots, self.cfg.max_len)
        natural_wait_s = step_s * min(self._remaining(i) for i in self.table.active_slots())
        if price_s >= natural_wait_s:
            log.debug("preemption not worth it: spill round trip %.3gs >= "
                      "natural slot free in %.3gs", price_s, natural_wait_s)
            return
        # victim: most remaining work; deterministic tie-break on rid
        victim = max(candidates,
                     key=lambda i: (self._remaining(i), self.table.slots[i]))
        self._spill(victim, spill_to)

    def _spill(self, i: int, spill_to) -> None:
        rid = self.table.slots[i]
        t0 = time.perf_counter()
        rows = self.engine.extract_slot(i, spill_to)
        spilled = self.table.suspend(i, self._tick)
        spilled.rows = rows
        spilled.tier = spill_to.tier
        faults = self.runtime.faults
        if self._verifying():
            # the parked rows' checksum where they lie, verified there before
            # the promotion's copy back; only with spill verification or
            # fault injection on
            spilled.checksum = checksum_tree(self.engine.summable(rows))
        if faults:
            ev = faults.check("spill")
            if ev is not None and ev.kind is FaultKind.SPILL_CORRUPT:
                spilled.rows = corrupt_tree(spilled.rows)
        spilled.spill_s = time.perf_counter() - t0
        self._spilled[rid] = spilled
        self._waitq.append(("spilled", rid))
        self._wait_since[rid] = self._tick
        self._requests[rid].preemptions += 1
        self._counters["preemptions"] += 1
        self._sync_state()
        log.info("preempted rid %d (slot %d, %d tokens resident) -> %s",
                 rid, i, spilled.length, spill_to.to_str())

    # -- live re-placement -------------------------------------------------
    def replan(self, policy=None, *, force: bool = False) -> bool:
        """Re-place the live KV cache (and params) mid-serve — see
        :meth:`~repro_torch.serve.engine.Executor.replan`.  Priced against
        the live :meth:`occupancy`."""
        return self.engine.replan(policy, force=force, occupancy=self.occupancy())

    def _maybe_auto_replan(self) -> None:
        """Fire :meth:`replan` when occupancy crosses a band boundary —
        only for planner-owned policies (a forced ``cfg.policy`` pins
        placement; call :meth:`replan` explicitly to move it)."""
        if not self.cfg.auto_replan or self.cfg.policy is not None:
            return
        band = int(self.occupancy() * max(self.cfg.replan_bands, 1))
        if band != self._replan_band:
            self._replan_band = band
            self.replan()

    # -- tier-loss recovery ------------------------------------------------
    def _lose_tier(self, tier) -> None:
        """Degrade off ``tier`` and keep serving: evacuate the live
        KV/params roles (planner re-pick excluding the lost tier, steps
        rebuilt), replay any spilled sequence whose parked rows lived
        there, and re-sync the device state."""
        # un-claim any slot caught mid-admission (claimed, prefill never
        # completed): free the row and put its request back at the head
        for i in range(self.table.batch_slots):
            rid = self.table.slots[i]
            if rid is not None and not bool(self.table.active[i]):
                self.table.free(i)
                self._requeue_fresh(rid)
        self.engine.evacuate(tier, occupancy=self.occupancy())
        # parked rows on a lost tier: drop them and replay the request
        # from its prompt + generated tokens
        for rid, sp in list(self._spilled.items()):
            if sp.tier is not None and sp.tier in self.runtime.lost_tiers:
                self._spilled.pop(rid)
                self._requeue_fresh(rid)
        self._sync_state()

    def _recover_tier_loss(self, e: TierLossError) -> None:
        self._counters["tier_losses"] += 1
        log.warning("tier loss at tick %d: %s — evacuating and continuing "
                    "degraded", self._tick, e)
        self._lose_tier(e.tier)

    def _escalate(self, action: str) -> None:
        """Act on a watchdog verdict: ``stall`` counts; ``retry`` rebuilds
        the steps (on a card: both graphs captured again, the live rows
        kept); ``evacuate`` degrades off the presumed-slow far tier;
        ``hang`` raises :class:`ServeHangError`."""
        if action == "stall":
            self._counters["watchdog_stalls"] += 1
            return
        if action == "retry":
            self._counters["watchdog_retries"] += 1
            log.warning("watchdog retry: rebuilding the steps")
            self.engine._build_steps()
            return
        if action == "evacuate":
            far = [
                self.policy.placement(r).tier
                for r in (Role.KV_CACHE, Role.PARAMS)
                if self.policy.placement(r).tier is not MemoryTier.HBM
                and self.policy.placement(r).tier not in self.runtime.lost_tiers
            ]
            if not far:
                # nothing left to degrade; the ladder continues to hang
                self._counters["watchdog_stalls"] += 1
                return
            self._counters["watchdog_evacuations"] += 1
            log.warning("watchdog evacuate: abandoning presumed-degraded tier %s",
                        far[0].value)
            self._lose_tier(far[0])
            return
        if action == "hang":
            raise ServeHangError(
                f"watchdog: {self.watchdog.breaches} consecutive steps "
                f"over the {self.watchdog.deadline_s():.3g}s deadline "
                f"(last step {self.watchdog.last_step_s:.3g}s)",
                queue_depth=self.queue_depth,
                live_rids=self.live_rids,
                stats=self.stats(),
            )

    # -- one decode tick ---------------------------------------------------
    def step(self) -> int:
        """Reap, preempt, admit/promote, then decode one token for every
        active slot.  Returns the number of active slots.

        The decode step advances the on-device state in place; the only
        per-step device→host traffic is the packed (2, B) token/stopped
        vector.  Tokens stream to ``on_token`` callbacks the tick they are
        decoded.  A :class:`~repro_torch.core.faults.TierLossError` from
        any dispatch is caught here: the server evacuates the lost tier,
        rebuilds its steps, replays what was parked there, and continues
        degraded.  The watchdog deadlines the decode against the
        runtime's step price and escalates consecutive breaches.
        """
        self._tick += 1
        self._reap_cancelled_expired()
        try:
            return self._step_inner()
        except TierLossError as e:
            self._recover_tier_loss(e)
            return 0

    def _step_inner(self) -> int:
        self._maybe_preempt()
        self._admit()
        self._maybe_auto_replan()
        active = self.table.active_slots()
        if not active:
            return 0
        now = time.perf_counter
        t0 = now()
        tokens, stopped = self.engine.decode()
        decode_dt = now() - t0
        self.engine.counters["decode_tokens"] += len(active)
        freed = False
        for i in active:
            rid = self.table.slots[i]
            req = self._requests[rid]
            tok = int(tokens[i])
            redo = self._replaying.get(rid)
            if redo:
                # a replay decodes what the request emitted before, again
                want = redo.pop(0)
                if not redo:
                    del self._replaying[rid]
                if tok != want:
                    raise RuntimeError(
                        f"request {rid}: replay decoded {tok} at generated position "
                        f"{len(req.out_tokens) - len(redo) - 1}, {want} before: the "
                        "decode step is not deterministic per row")
                self.table.advance(i, tok)
                continue
            req.out_tokens.append(tok)
            if req.first_token_s is None:
                req.first_token_s = now()
            self.table.advance(i, tok)
            if (
                bool(stopped[i])
                or len(req.out_tokens) >= req.max_new_tokens
                or self.table.lengths[i] >= self.cfg.max_len - 1
            ):
                req.done = True
                req.finished_s = now()
                self._free_slot(i)
                freed = True
            if req.on_token is not None:
                req.on_token(req, tok)
        if freed:
            self._sync_state()
            self._maybe_auto_replan()
        # the watchdog reads the decode's wall time (admission excluded;
        # the first step after a build pays set-up and is skipped, the
        # rule of the step EWMA)
        if self.watchdog is not None and self.engine._steps_since_build > 1:
            self._escalate(self.watchdog.observe(decode_dt))
        return len(active)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        """Drive :meth:`step` until nothing is live.  Exhausting
        ``max_steps`` with work still queued raises :class:`ServeHangError`
        — never a silent return with requests stranded."""
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        if not self.has_work():
            return
        raise ServeHangError(
            f"serve loop did not drain within max_steps={max_steps}",
            queue_depth=self.queue_depth,
            live_rids=self.live_rids,
            stats=self.stats(),
        )


class Scheduler:
    """Asyncio front end over a :class:`Server`.

    ``await submit()`` absorbs :class:`QueueFullError` by waiting for
    queue space; :meth:`stream` yields tokens as the driver loop decodes
    them; and :meth:`run` drives the server until it is closed *and*
    drained — steps run in a worker thread (``asyncio.to_thread``) so the
    event loop keeps serving submissions and streams between ticks::

        server = Server(bundle, ServeConfig(...), params)
        sched = Scheduler(server)
        async def client():
            req = await sched.submit(prompt, max_new_tokens=32)
            async for tok in sched.stream(req):
                ...
            sched.close()
        await asyncio.gather(sched.run(), client())

    On a card the worker thread replays the server's graphs: every step
    runs on that one thread at a time, the device's streams and the
    captured buffers being the server's.
    """

    def __init__(self, server: Server, *, step_timeout_s: float | None = 60.0):
        self.server = server
        #: off-thread bound on one server.step(); a step that outlives it
        #: surfaces as ServeHangError.  None = unbounded.
        self.step_timeout_s = step_timeout_s
        self._tick_ev = asyncio.Event()
        self._closed = False

    def _notify(self) -> None:
        ev, self._tick_ev = self._tick_ev, asyncio.Event()
        ev.set()

    async def _wait_tick(self) -> None:
        ev = self._tick_ev
        await ev.wait()

    async def submit(self, prompt, **kw) -> Request:
        """Queue a request, awaiting queue space under backpressure.
        Raises :class:`SchedulerClosed` (immediately, or on wake while
        waiting for space) once :meth:`close` has been called."""
        while True:
            if self._closed:
                raise SchedulerClosed("scheduler closed; submission cancelled")
            try:
                return self.server.submit(prompt, **kw)
            except QueueFullError:
                await self._wait_tick()

    async def stream(self, req: Request):
        """Async-yield ``req``'s tokens as they are decoded.  A stream
        that can no longer finish — the scheduler closed and the server
        drained without completing ``req`` — raises
        :class:`SchedulerClosed` instead of waiting forever."""
        sent = 0
        while True:
            while sent < len(req.out_tokens):
                yield req.out_tokens[sent]
                sent += 1
            if req.done:
                return
            if self._closed and not self.server.has_work():
                raise SchedulerClosed(
                    f"scheduler closed with request {req.rid} unfinished")
            await self._wait_tick()

    async def run(self) -> None:
        """Drive the server until :meth:`close` is called and every live
        request has drained.  Each off-thread step is bounded by
        ``step_timeout_s``."""
        try:
            while not (self._closed and not self.server.has_work()):
                if self.server.has_work():
                    step = asyncio.to_thread(self.server.step)
                    if self.step_timeout_s is None:
                        await step
                    else:
                        try:
                            await asyncio.wait_for(step, self.step_timeout_s)
                        except asyncio.TimeoutError:
                            raise ServeHangError(
                                "serve step exceeded the scheduler's "
                                f"{self.step_timeout_s:.3g}s off-thread bound",
                                queue_depth=self.server.queue_depth,
                                live_rids=self.server.live_rids,
                                stats=self.server.stats(),
                            ) from None
                else:
                    await asyncio.sleep(0.001)
                self._notify()
        finally:
            self._notify()

    def close(self) -> None:
        """Let :meth:`run` return once the last live request drains, and
        wake every ``submit()``/``stream()`` waiter so those that can no
        longer complete fail fast with :class:`SchedulerClosed`."""
        self._closed = True
        self._notify()
