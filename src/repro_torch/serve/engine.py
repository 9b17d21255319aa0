"""Executor: the device half of the serve stack.

Counterpart of ``repro/serve/engine.py`` (``decode``, ``prefill``,
``_chunked_prefill``, ``measured_step_s`` and the counters).  It owns the
params, the KV cache and the serve state's fixed buffers, and runs every
dispatch; it knows nothing of requests or queues.

The reference compiles its two steps ahead of time (``_build_steps``:
``jax.jit(...).lower(...).compile()``) and donates the cache.  Here:

* **Compiled steps are CUDA graphs.**  The whole decode step —
  ``decode_step``, sampling, stop detection, the tokens/lengths advance
  and the packed ``(2, B)`` result — is one function over fixed buffers
  (:meth:`_decode_step`), and so is one chunked-prefill dispatch over
  fixed ``tokens``/``new_lens``/``offsets`` buffers
  (:meth:`_prefill_step`).  On the card each is warmed up eagerly on a
  side stream (which also builds every kernel and sets its shared-memory
  attributes) and captured once per Executor, at (``batch_slots``,
  ``max_len``) and (``batch_slots``, ``prefill_chunk``); every step then
  replays its graph.  A failed capture or replay raises: there is no
  fallback to the eager path.  ``eager=True`` runs the same functions
  without graphs on the card (for comparing the two); the CPU always
  runs them eagerly.
* **In-place cache** — the model writes each step's keys and values
  straight into ``self.caches``: one cache, never copied or reallocated.
* **Chunked batched prefill** — admission writes whole prompt chunks for
  all newly claimed slots per dispatch, so a batch of length-L prompts
  costs O(L / prefill_chunk) dispatches.
* **On-device serve state** — sampling and stop detection run on the
  device; the only per-step device→host traffic is one packed ``(2, B)``
  next-token/stopped vector, fetched once into a pinned buffer.

Placement (the reference's ``Runtime``), preemption, replan/evacuate and
fault injection are not ported yet; on one device with no host tier the
reference picks ``hbm_resident``, which is what this executor does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_prefill
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.serve import sampling as sampling_mod
from repro_torch.serve.state import DeviceState, Uploader

#: the kernel wrappers a serving step may launch, by kernel name
KERNELS = {"decode_attention": flash_decode, "prefill_attention": flash_prefill,
           "ssd_scan": ssd_scan}
#: eager runs on a side stream before a capture (PyTorch's CUDA-graph notes)
WARMUP_RUNS = 3
#: weights of the decode-step wall-time EWMA (the reference's)
_EWMA_OLD, _EWMA_NEW = 0.8, 0.2


def _launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


class Executor:
    """Decode/prefill dispatches over one model bundle.

    ``cfg`` is the scheduler's ``ServeConfig`` (only the shape fields are
    read here).  ``params`` must already lie on ``device``.  On a CUDA
    device the steps are captured as CUDA graphs here, unless ``eager``.
    """

    def __init__(self, bundle, cfg, params, device=None, *, eager: bool = False):
        self.bundle = bundle
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        B, C = cfg.batch_slots, max(int(cfg.prefill_chunk), 1)
        self.caches = bundle.init_cache(B, cfg.max_len, device=self.device)
        #: the serve state's fixed buffers (the decode graph's inputs)
        self.state = DeviceState(B, self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        #: the prefill dispatch's fixed inputs
        self.prefill_in = {"tokens": torch.zeros((B, C), **i32),
                           "new_lens": torch.zeros((B,), **i32),
                           "offsets": torch.zeros((B,), **i32)}
        self._prefill_up = Uploader(self.prefill_in)
        #: the decode step's packed (next token, stopped) result
        self.out = torch.zeros((2, B), **i32)
        self._out_host = (self.out.cpu().pin_memory()
                          if self.device.type == "cuda" else None)
        #: phase counters (tokens, wall seconds, dispatches, graph replays)
        self.counters = {
            "prefill_tokens": 0, "prefill_s": 0.0, "prefill_dispatches": 0,
            "decode_tokens": 0, "decode_s": 0.0, "decode_steps": 0,
            "decode_replays": 0, "prefill_replays": 0,
        }
        self._step_ewma: float | None = None
        self.graphed = self.device.type == "cuda" and not eager
        #: per graph, the kernel launches one replay makes (counted while
        #: capturing: the wrappers' counters tick at capture, not replay)
        self.graph_launches: dict[str, dict[str, int]] = {}
        self._graphs: dict[str, torch.cuda.CUDAGraph] = {}
        if self.graphed:
            self._graphs["decode"] = self._capture("decode", self._decode_step)
            self._graphs["prefill"] = self._capture("prefill", self._prefill_step)

    # -- the steps the graphs capture ---------------------------------------
    @torch.no_grad()
    def _decode_step(self) -> None:
        """One decode step over every slot, reading and writing only the
        fixed buffers and the caches."""
        s = self.state
        logits, _ = self.bundle.decode_step(
            self.params, {"tokens": s["tokens"], "lengths": s["lengths"]},
            self.caches,
        )
        # greedy rows (temp == 0) take the plain argmax
        next_tok = sampling_mod.sample_tokens(logits, s)            # (B,)
        stopped = sampling_mod.hit_stop(next_tok, s["stop"])
        active = s["active"]
        self.out[0].copy_(next_tok)
        self.out[1].copy_(stopped & active)
        # inactive rows keep their token/length so idle slots and freshly
        # prefilled slots ride through untouched
        s["tokens"].copy_(torch.where(active[:, None], next_tok[:, None],
                                      s["tokens"]))
        s["lengths"].add_(active.to(torch.int32))

    @torch.no_grad()
    def _prefill_step(self) -> None:
        """One chunked-prefill dispatch over the fixed prefill inputs."""
        p = self.prefill_in
        self.bundle.prefill_at(
            self.params, {"tokens": p["tokens"], "new_lens": p["new_lens"]},
            self.caches, p["offsets"],
        )

    def _capture(self, name: str, step) -> torch.cuda.CUDAGraph:
        """Warm ``step`` up on a side stream, then capture it.

        The warm-up runs on the all-idle state of a new Executor (rows
        that are inactive or take no new tokens), so it changes nothing a
        request will read.  A failed capture raises from here."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        after = _launch_counts()
        self.graph_launches[name] = {k: after[k] - before[k] for k in after
                                     if after[k] > before[k]}
        return graph

    def _run(self, name: str, step) -> None:
        if self.graphed:
            self._graphs[name].replay()
            self.counters[f"{name}_replays"] += 1
        else:
            step()

    # -- decode ------------------------------------------------------------
    def decode(self) -> tuple[np.ndarray, np.ndarray]:
        """One decode step over every slot, advancing the device state.

        Returns ``(next_tokens (B,), stopped (B,) bool)``; the packed
        result is the step's only device→host transfer.
        """
        t0 = time.perf_counter()
        self._run("decode", self._decode_step)
        # the one fetch per step: the packed (2, B) vector
        if self._out_host is None:
            out = self.out.numpy().copy()
        else:
            self._out_host.copy_(self.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = self._out_host.numpy().copy()
        dt = time.perf_counter() - t0
        self.counters["decode_s"] += dt
        self.counters["decode_steps"] += 1
        if self.counters["decode_steps"] > 1:       # the first pays set-up
            self._step_ewma = (dt if self._step_ewma is None
                               else _EWMA_OLD * self._step_ewma + _EWMA_NEW * dt)
        return out[0], out[1].astype(bool)

    @property
    def measured_step_s(self) -> float | None:
        """EWMA of the decode step's wall time after its first call (None
        before the second step)."""
        return self._step_ewma

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.counters["prefill_tokens"] += sum(
            len(prompt) - 1 for _, prompt in new
        )
        self.counters["prefill_s"] += time.perf_counter() - t0

    def dispatch_prefill(self, tokens: np.ndarray, new_lens: np.ndarray,
                         offsets: np.ndarray) -> None:
        """One chunked-prefill dispatch: row ``b`` appends
        ``new_lens[b]`` of its ``(batch_slots, prefill_chunk)`` tokens at
        cache position ``offsets[b]`` (the graph's replay on the card).
        Queued, not waited for."""
        self._prefill_up.put({"tokens": tokens, "new_lens": new_lens,
                              "offsets": offsets})
        self._run("prefill", self._prefill_step)
        self.counters["prefill_dispatches"] += 1

    def _chunked_prefill(self, new, table) -> None:
        chunk = self.prefill_in["tokens"].shape[1]
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
            self.dispatch_prefill(toks, new_lens, table.lengths)
            for i, _ in new:
                table.lengths[i] += int(new_lens[i])
