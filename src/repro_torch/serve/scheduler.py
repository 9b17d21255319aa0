"""Scheduler: the continuous-batching front end of the serve stack.

Counterpart of ``repro/serve/scheduler.py`` for fresh requests: a wait
queue with FIFO admission, batched chunked prefill of newly admitted
requests while other rows keep decoding, streaming per-token callbacks,
and retirement on a stop token, ``max_new_tokens`` or the cache extent.

Placement: ``ServeConfig.policy`` forces a placement policy, or leaves
the pick to the planner; the :class:`Executor` realizes it through its
:class:`~repro_torch.api.Runtime` (``server.runtime``).

Not ported yet (ROADMAP A11): planner-priced preemption and promotion,
replan and tier-loss evacuation, fault injection, the watchdog,
cancel/deadlines, and the asyncio ``Scheduler``.  ``ServeConfig`` carries
none of their fields.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np

from repro_torch.core.placement import PlacementPolicy, parse_policy
from repro_torch.serve.engine import Executor
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.state import SlotTable

log = logging.getLogger("repro_torch.serve.scheduler")


class QueueFullError(RuntimeError):
    """Backpressure: the bounded wait queue is at ``cfg.max_queue``."""


class ServeHangError(RuntimeError):
    """The serve loop failed to make progress: ``run_until_done``
    exhausted its step budget with live requests still queued.  Carries
    the queue depth, the live rids, and the last stats snapshot."""

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


@dataclasses.dataclass
class Request:
    """One generation request.

    ``sampling`` defaults to greedy; ``on_token`` streams each generated
    token as ``on_token(request, token)`` the tick it is decoded.  The
    ``*_s`` fields are ``time.perf_counter`` stamps.
    """

    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int
    sampling: SamplingParams = GREEDY
    on_token: Callable[["Request", int], None] | None = None
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_s: float | None = None
    first_token_s: float | None = None
    finished_s: float | None = None


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
    #: bound on *waiting* (not yet admitted) requests; None = unbounded.
    #: add_request raises QueueFullError beyond it.
    max_queue: int | None = None

    def __post_init__(self):
        if self.policy is not None:
            self.policy = parse_policy(self.policy)


class Server:
    """Single-model continuous-batching server on one device.

    Composes the wait queue with the :class:`Executor` (``server.engine``:
    params, caches, the device state's fixed buffers, the compiled steps)
    and the :class:`SlotTable` (``server.table``).  On the card the steps
    replay CUDA graphs; ``eager=True`` runs them without graphs, to
    compare the two.
    """

    def __init__(self, bundle, cfg: ServeConfig, params, device=None, *,
                 eager: bool = False):
        self.bundle = bundle
        self.cfg = cfg
        self.engine = Executor(bundle, cfg, params, device, eager=eager)
        self.device = self.engine.device
        self.table = SlotTable(cfg.batch_slots)
        self._requests: dict[int, Request] = {}
        #: FIFO of rids never yet admitted
        self._waitq: list[int] = []
        self._next_rid = 0
        self._counters = {"peak_queue": 0}

    # -- introspection -----------------------------------------------------
    @property
    def params(self):
        return self.engine.params

    @property
    def runtime(self):
        """The executor's :class:`~repro_torch.api.Runtime` (device,
        policy, planner)."""
        return self.engine.runtime

    @property
    def policy(self) -> PlacementPolicy:
        return self.engine.policy

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot — what ``max_queue`` bounds."""
        return len(self._waitq)

    @property
    def live_rids(self) -> tuple[int, ...]:
        """rids of all live (queued or active) requests."""
        return tuple(self._requests)

    def has_work(self) -> bool:
        """Anything queued or decoding?"""
        return bool(self._waitq or self.table.active_slots())

    def stats(self) -> dict:
        """Executor phase counters merged with the scheduler's and the live
        queue depth."""
        return {**self.engine.counters, **self._counters,
                "queued": self.queue_depth}

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

        When every slot is busy the request waits its turn.  The only
        rejections are malformed requests and the bounded-queue
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
        self._waitq.append(req.rid)
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

    # -- admission ---------------------------------------------------------
    def _sync_state(self) -> None:
        """Copy the mirrors into the device state's fixed buffers after a
        slot lifecycle event (admission / free).  Steady-state decode
        never calls this."""
        self.engine.state.load(self.table)

    def _free_slot(self, i: int) -> int | None:
        """The one place an occupied slot returns to the pool: clears the
        table row and evicts the rid's bookkeeping together."""
        rid = self.table.free(i)
        if rid is not None:
            self._requests.pop(rid, None)
        return rid

    def _admit(self) -> None:
        """Fill free slots from the wait queue, FIFO; the admitted
        requests are prefilled together in one set of chunked dispatches."""
        free = self.table.free_slots()
        fresh: list[tuple[int, Request]] = []
        while free and self._waitq:
            rid = self._waitq.pop(0)
            i = free.pop(0)
            req = self._requests[rid]
            self.table.claim(i, rid, req.sampling)
            fresh.append((i, req))
        if not fresh:
            return
        self.engine.prefill([(i, req.prompt) for i, req in fresh], self.table)
        for i, req in fresh:
            self.table.last_tokens[i, 0] = req.prompt[-1]
            self.table.active[i] = True
        self._sync_state()

    # -- one decode tick ---------------------------------------------------
    def step(self) -> int:
        """Admit, then decode one token for every active slot.  Returns
        the number of active slots.

        The decode step advances the on-device state in place; the only
        per-step device→host traffic is the packed (2, B) token/stopped
        vector.  Tokens stream to ``on_token`` callbacks the tick they are
        decoded.
        """
        self._admit()
        active = self.table.active_slots()
        if not active:
            return 0
        now = time.perf_counter
        tokens, stopped = self.engine.decode()
        self.engine.counters["decode_tokens"] += len(active)
        freed = False
        for i in active:
            req = self._requests[self.table.slots[i]]
            tok = int(tokens[i])
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
