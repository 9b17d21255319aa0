"""Slot state: host mirrors, the device serve state's fixed buffers, uploads.

Counterpart of ``repro/serve/state.py`` (no spill records: preemption is
not ported yet).  A :class:`SlotTable` owns the per-slot host mirrors
(length, last token, active flag, sampling parameters).  The device side
is a :class:`DeviceState`: one fixed tensor per field, allocated once per
``Executor`` on its device, which the decode step reads and advances in
place.  Host mirrors advance from the token vector the step *returns*;
they are copied into the buffers again only on slot lifecycle events —
admission and free — never per decode step.

The buffers never move: a CUDA graph captured over them reads the same
addresses at every replay, so an upload must write into them
(:class:`Uploader`) and never rebind a field to a new tensor.

Upload discipline: a host buffer handed to the device must never see a
later write while the copy may still read it.  On the card every buffer
has a pinned staging twin; the copies are asynchronous, and the next
upload first waits on the event recorded after them before it writes the
staging again.  On the CPU the copy is synchronous.
"""

from __future__ import annotations

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
        self._uploader.put(table.mirrors())


class SlotTable:
    """Host mirrors of the per-slot serve state, one row per cache slot.

    The single owner of slot bookkeeping: which rid holds each slot, each
    row's fill/last-token/active mirrors, and the per-slot sampling rows
    the device state carries.  All mutation goes through :meth:`claim` /
    :meth:`advance` / :meth:`free` so a row is never half-updated.
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

    # -- lifecycle ---------------------------------------------------------
    def claim(self, i: int, rid: int, sampling: SamplingParams) -> None:
        """Assign a fresh request to a free slot (prefill fills the rest)."""
        assert self.slots[i] is None, (i, self.slots[i])
        self.slots[i] = rid
        self.lengths[i] = 0
        self.temp[i] = sampling.temperature
        self.top_k[i] = sampling.top_k
        self.top_p[i] = sampling.top_p
        self.seed[i] = sampling.seed
        self.stop[i] = sampling.stop_row()

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

    # -- device state ------------------------------------------------------
    def mirrors(self) -> dict[str, np.ndarray]:
        """The mirrors under the :data:`STATE_FIELDS` names."""
        return {
            "tokens": self.last_tokens, "lengths": self.lengths,
            "active": self.active, "temp": self.temp, "top_k": self.top_k,
            "top_p": self.top_p, "seed": self.seed, "stop": self.stop,
        }
