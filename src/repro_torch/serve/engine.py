"""Executor: the device half of the serve stack.

Counterpart of ``repro/serve/engine.py`` (``decode``, ``prefill``,
``_chunked_prefill`` and the counters).  It owns the params and the KV
cache and runs every dispatch; it knows nothing of requests or queues.

Where the reference jits and donates, the port runs eagerly and updates
in place:

* **In-place cache** — the reference donates the cache pytree to its
  decode/prefill jits so XLA aliases the new cache onto the old buffer.
  Here the model writes each step's keys and values straight into
  ``self.caches`` (per-layer views of the stacked tensors): one cache,
  never copied, never reallocated.
* **Chunked batched prefill** — admission writes whole prompt chunks for
  all newly claimed slots per :meth:`ModelBundle.prefill_at` dispatch, so
  a batch of length-L prompts costs O(L / prefill_chunk) dispatches.
* **On-device serve state** — lengths/last-token/active and the per-slot
  sampling parameters live in a device state dict; sampling and stop
  detection run on the device, and the only per-step device→host traffic
  is one packed ``(2, B)`` next-token/stopped vector, fetched once.

Placement (the reference's ``Runtime``, planner and policies), preemption
(slot extract/insert), replan/evacuate and fault injection are not ported
yet; on one device with no host tier the reference picks ``hbm_resident``,
which is what this executor does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serve import sampling as sampling_mod
from repro_torch.serve.state import upload

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """Decode/prefill dispatches over one model bundle.

    ``cfg`` is the scheduler's ``ServeConfig`` (only the shape fields are
    read here).  ``params`` must already lie on ``device``.
    """

    def __init__(self, bundle, cfg, params, device=None):
        self.bundle = bundle
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.caches = bundle.init_cache(
            cfg.batch_slots, cfg.max_len, device=self.device
        )
        #: phase counters (tokens, wall seconds, dispatches)
        self.counters = {
            "prefill_tokens": 0, "prefill_s": 0.0, "prefill_dispatches": 0,
            "decode_tokens": 0, "decode_s": 0.0, "decode_steps": 0,
        }

    # -- decode ------------------------------------------------------------
    def decode(self, state: dict) -> tuple[np.ndarray, np.ndarray, dict]:
        """One decode step over every slot.

        Returns ``(next_tokens (B,), stopped (B,) bool, new_state)``; the
        packed result is the step's only device→host transfer.
        """
        t0 = time.perf_counter()
        logits, self.caches = self.bundle.decode_step(
            self.params,
            {"tokens": state["tokens"], "lengths": state["lengths"]},
            self.caches,
        )
        # greedy rows (temp == 0) take the plain argmax
        next_tok = sampling_mod.sample_tokens(logits, state)          # (B,)
        stopped = sampling_mod.hit_stop(next_tok, state["stop"])
        active = state["active"]
        new_state = dict(
            state,
            # inactive rows keep their token/length so idle slots and
            # freshly prefilled slots ride through untouched
            tokens=torch.where(active[:, None], next_tok[:, None],
                               state["tokens"]),
            lengths=state["lengths"] + active.to(torch.int32),
        )
        # the one fetch per step: the packed (2, B) vector
        out = torch.stack([next_tok, (stopped & active).to(torch.int32)])
        out_host = out.cpu().numpy()
        self.counters["decode_s"] += time.perf_counter() - t0
        self.counters["decode_steps"] += 1
        return out_host[0], out_host[1].astype(bool), new_state

    # -- prefill (admission) ----------------------------------------------
    def prefill(self, new, table) -> None:
        """Write the newly claimed rows' prompts into the cache.

        ``new`` is ``[(slot, prompt ndarray), ...]``; ``table`` is the
        scheduler's :class:`~repro_torch.serve.state.SlotTable`, whose
        ``lengths`` mirror advances as chunks land.  The last prompt token
        is withheld: the first decode step feeds it so its logits produce
        the first generated token.  Waits for the device at the end so
        the prefill/decode split in the counters is honest.
        """
        t0 = time.perf_counter()
        self._chunked_prefill(new, table)
        _sync(self.device)
        self.counters["prefill_tokens"] += sum(
            len(prompt) - 1 for _, prompt in new
        )
        self.counters["prefill_s"] += time.perf_counter() - t0

    def _chunked_prefill(self, new, table) -> None:
        chunk = max(int(self.cfg.prefill_chunk), 1)
        lens = {i: len(prompt) - 1 for i, prompt in new}
        # at least one dispatch even when every prompt has length 1, as
        # the reference does (recurrent layers reset state there)
        max_len = max(max(lens.values()), 1)
        B = self.cfg.batch_slots
        for lo in range(0, max_len, chunk):
            toks = np.zeros((B, chunk), np.int32)
            new_lens = np.zeros(B, np.int32)
            for i, prompt in new:
                n = int(np.clip(lens[i] - lo, 0, chunk))
                if n > 0:
                    toks[i, :n] = prompt[lo : lo + n]
                    new_lens[i] = n
            # toks/new_lens are fresh per chunk; lengths is a live mirror
            # and goes through the copying upload
            _, self.caches = self.bundle.prefill_at(
                self.params,
                {
                    "tokens": upload(toks, np.int32, self.device),
                    "new_lens": upload(new_lens, np.int32, self.device),
                },
                self.caches,
                upload(table.lengths, np.int32, self.device),
            )
            self.counters["prefill_dispatches"] += 1
            for i, _ in new:
                table.lengths[i] += int(new_lens[i])
