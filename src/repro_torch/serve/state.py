"""Slot state: host mirrors, the device serve state, and upload rules.

Counterpart of ``repro/serve/state.py`` (no spill records: preemption is
not ported yet).  A :class:`SlotTable` owns the per-slot host mirrors
(length, last token, active flag, sampling parameters) and builds the
device-side state dict the decode step carries.  Host mirrors advance from
the token vector the step *returns*; they are uploaded again only on slot
lifecycle events — admission and free — never per decode step.

Upload discipline (:func:`upload`): a buffer handed to the device must
never see a later write.  ``torch.from_numpy(mirror).to(dev,
non_blocking=True)`` can read the mirror after the host has moved on and
mutated it, so every upload first takes a private copy nothing else
writes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.sampling import STOP_WIDTH, SamplingParams


def upload(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """Device copy of a host mirror that can NEVER see later writes."""
    return torch.from_numpy(np.array(arr, dtype=dtype, copy=True)).to(device)


def idle_device_state(batch_slots: int, device) -> dict:
    """All-idle device state with the canonical schema — same keys, shapes
    and dtypes as :meth:`SlotTable.device_state`."""
    B = batch_slots
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "tokens": torch.zeros((B, 1), **i32),
        "lengths": torch.zeros((B,), **i32),
        "active": torch.zeros((B,), dtype=torch.bool, device=device),
        "temp": torch.zeros((B,), dtype=torch.float32, device=device),
        "top_k": torch.zeros((B,), **i32),
        "top_p": torch.ones((B,), dtype=torch.float32, device=device),
        "seed": torch.zeros((B,), dtype=torch.int64, device=device),
        "stop": torch.full((B, STOP_WIDTH), -1, **i32),
    }


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
    def device_state(self, device) -> dict:
        """Fresh device serve state from the mirrors (lifecycle events
        only — steady-state decode carries the state on the device)."""
        return {
            "tokens": upload(self.last_tokens, np.int32, device),
            "lengths": upload(self.lengths, np.int32, device),
            "active": upload(self.active, bool, device),
            "temp": upload(self.temp, np.float32, device),
            "top_k": upload(self.top_k, np.int32, device),
            "top_p": upload(self.top_p, np.float32, device),
            "seed": upload(self.seed, np.int64, device),
            "stop": upload(self.stop, np.int32, device),
        }
