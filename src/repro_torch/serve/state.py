"""Slot state: host mirrors, the device serve state's fixed buffers, uploads.

Counterpart of ``repro/serve/state.py``.  A :class:`SlotTable` owns the
per-slot host mirrors (length, last token, active flag, sampling
parameters).  The device side is a :class:`DeviceState`: one fixed tensor
per field, allocated once per ``Executor`` on its device, which the
decode step reads and advances in place.  Host mirrors advance from the
token vector the step *returns*; they are copied into the buffers again
only on slot lifecycle events — admission, free, suspend (preemption
spill), resume (promotion) — never per decode step.

The buffers never move: a CUDA graph captured over them reads the same
addresses at every replay, so an upload must write into them
(:class:`Uploader`) and never rebind a field to a new tensor.

Upload discipline: a host buffer handed to the device must never see a
later write while the copy may still read it.  On the card every buffer
has a pinned staging twin; the copies are asynchronous, and the next
upload first waits on the event recorded after them before it writes the
staging again.  On the CPU the copy is synchronous.

:class:`SpilledSequence` is the off-cache parking record of a preempted
request: its cache rows (on the planner-priced spill tier), its resume
state, and the tick it started waiting — what promotion needs to put it
back bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve.sampling import STOP_WIDTH, SamplingParams

#: the device serve state: field -> (per-slot trailing shape, dtype, idle value)
STATE_FIELDS: dict[str, tuple[tuple[int, ...], torch.dtype, object]] = {
    "tokens": ((1,), torch.int32, 0),
    "lengths": ((), torch.int32, 0),
    "active": ((), torch.bool, False),
    "temp": ((), torch.float32, 0.0),
    "top_k": ((), torch.int32, 0),
    "top_p": ((), torch.float32, 1.0),
    "seed": ((), torch.int64, 0),
    "stop": ((STOP_WIDTH,), torch.int32, -1),
}


class Uploader:
    """Copies host arrays into a fixed set of device buffers in place."""

    def __init__(self, buffers: dict[str, torch.Tensor]):
        self.buffers = buffers
        self.device = next(iter(buffers.values())).device
        self._staging = self._done = None
        if self.device.type == "cuda":
            self._staging = {k: torch.empty_like(b, device="cpu").pin_memory()
                             for k, b in buffers.items()}
            self._done = torch.cuda.Event()

    def put(self, values: dict[str, np.ndarray]) -> None:
        """``buffers[k] <- values[k]`` for each given field, queued on the
        device's current stream."""
        if self._staging is None:
            for k, arr in values.items():
                self.buffers[k].copy_(torch.from_numpy(np.asarray(arr)))
            return
        self._done.synchronize()        # the last copies out of the staging
        for k, arr in values.items():
            stage = self._staging[k]
            stage.numpy()[...] = arr
            self.buffers[k].copy_(stage, non_blocking=True)
        self._done.record(torch.cuda.current_stream(self.device))


class DeviceState:
    """The serve state's fixed device buffers (``state[field]``), idle at
    construction: the same fields, shapes and dtypes as
    :meth:`SlotTable.mirrors`."""

    def __init__(self, batch_slots: int, device):
        self.buffers = {
            name: torch.full((batch_slots, *tail), idle, dtype=dtype,
                             device=device)
            for name, (tail, dtype, idle) in STATE_FIELDS.items()
        }
        self._uploader = Uploader(self.buffers)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.buffers[name]

    def load(self, table: "SlotTable") -> None:
        """Copy every mirror of ``table`` into the buffers (lifecycle
        events only — steady-state decode advances the buffers on the
        device)."""
        self.put(table.mirrors())

    def put(self, values: dict[str, np.ndarray]) -> None:
        """Copy host arrays into the named buffers, in place."""
        self._uploader.put(values)


@dataclasses.dataclass
class SpilledSequence:
    """A preempted request parked off-cache: everything promotion needs."""

    rid: int
    rows: object            # per-slot cache-row tree, on the spill tier
    length: int             # cache fill at spill time
    last_token: int         # the token the next decode step feeds
    sampling: SamplingParams
    since_tick: int         # when it started waiting (promotion ordering)
    spill_s: float = 0.0    # seconds the spill copy took (stats)
    #: MemoryTier the rows are parked on (tier-loss recovery re-queues
    #: sequences parked on a lost tier as fresh replays)
    tier: object = None
    #: checksum_tree() of rows at park time; None = verification off.
    #: Promotion verifies against it and a mismatch replays the request.
    checksum: float | None = None


class SlotTable:
    """Host mirrors of the per-slot serve state, one row per cache slot.

    The single owner of slot bookkeeping: which rid holds each slot, each
    row's fill/last-token/active mirrors, and the per-slot sampling rows
    the device state carries.  All mutation goes through :meth:`claim` /
    :meth:`advance` / :meth:`free` / :meth:`suspend` / :meth:`resume` so a
    row is never half-updated.
    """

    def __init__(self, batch_slots: int):
        self.batch_slots = batch_slots
        self.slots: list[int | None] = [None] * batch_slots
        self.lengths = np.zeros(batch_slots, np.int32)
        self.last_tokens = np.zeros((batch_slots, 1), np.int32)
        self.active = np.zeros(batch_slots, bool)
        # per-slot sampling mirrors (greedy defaults)
        self.temp = np.zeros(batch_slots, np.float32)
        self.top_k = np.zeros(batch_slots, np.int32)
        self.top_p = np.ones(batch_slots, np.float32)
        self.seed = np.zeros(batch_slots, np.int64)
        self.stop = np.full((batch_slots, STOP_WIDTH), -1, np.int32)
        #: tick each slot was last (re)occupied — preemption's thrash
        #: guard (a just-admitted victim is not immediately re-spilled)
        self.claimed_tick = np.zeros(batch_slots, np.int64)

    # -- queries -----------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def slot_of(self, rid: int) -> int | None:
        try:
            return self.slots.index(rid)
        except ValueError:
            return None

    def occupancy(self, max_len: int) -> float:
        """Live cache utilization: resident tokens over the cache extent —
        what replan pricing feeds the planner."""
        return float(self.lengths.sum()) / float(self.batch_slots * max_len)

    # -- lifecycle ---------------------------------------------------------
    def _set_sampling(self, i: int, sampling: SamplingParams) -> None:
        self.temp[i] = sampling.temperature
        self.top_k[i] = sampling.top_k
        self.top_p[i] = sampling.top_p
        self.seed[i] = sampling.seed
        self.stop[i] = sampling.stop_row()

    def claim(self, i: int, rid: int, sampling: SamplingParams,
              tick: int = 0) -> None:
        """Assign a fresh request to a free slot (prefill fills the rest)."""
        assert self.slots[i] is None, (i, self.slots[i])
        self.slots[i] = rid
        self.lengths[i] = 0
        self._set_sampling(i, sampling)
        self.claimed_tick[i] = tick

    def resume(self, i: int, spilled: SpilledSequence, tick: int = 0) -> None:
        """Re-occupy a free slot with a promoted (previously spilled)
        sequence: mirrors restored to their values at spill time."""
        assert self.slots[i] is None, (i, self.slots[i])
        self.slots[i] = spilled.rid
        self.lengths[i] = spilled.length
        self.last_tokens[i, 0] = spilled.last_token
        self.active[i] = True
        self._set_sampling(i, spilled.sampling)
        self.claimed_tick[i] = tick

    def advance(self, i: int, token: int) -> None:
        """Steady-state per-token mirror advance from the *returned*
        token vector (no upload)."""
        self.lengths[i] += 1
        self.last_tokens[i, 0] = token

    def free(self, i: int) -> int | None:
        """The single place a slot returns to the pool: clears the slot
        assignment and every mirror row together.  Stale cache content
        beyond the zeroed length is masked out and overwritten by the next
        prefill.  Returns the evicted rid."""
        rid = self.slots[i]
        self.slots[i] = None
        self.lengths[i] = 0
        self.last_tokens[i, 0] = 0
        self.active[i] = False
        self.temp[i] = 0.0
        self.top_k[i] = 0
        self.top_p[i] = 1.0
        self.seed[i] = 0
        self.stop[i] = -1
        return rid

    def suspend(self, i: int, tick: int) -> SpilledSequence:
        """Snapshot a slot's resume state for a preemption spill, then
        clear the row (the executor extracts the cache rows).  The caller
        attaches the off-cache rows to the returned record."""
        rid = self.slots[i]
        spilled = SpilledSequence(
            rid=rid,
            rows=None,
            length=int(self.lengths[i]),
            last_token=int(self.last_tokens[i, 0]),
            sampling=SamplingParams(
                temperature=float(self.temp[i]),
                top_k=int(self.top_k[i]),
                top_p=float(self.top_p[i]),
                seed=int(self.seed[i]),
                stop_tokens=tuple(int(t) for t in self.stop[i] if t >= 0),
            ),
            since_tick=tick,
        )
        self.free(i)
        return spilled

    # -- device state ------------------------------------------------------
    def mirrors(self) -> dict[str, np.ndarray]:
        """The mirrors under the :data:`STATE_FIELDS` names."""
        return {
            "tokens": self.last_tokens, "lengths": self.lengths,
            "active": self.active, "temp": self.temp, "top_k": self.top_k,
            "top_p": self.top_p, "seed": self.seed, "stop": self.stop,
        }
