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
  costs O(L / prefill_chunk) dispatches.  An encoder-decoder bundle
  chunk-prefills its decoder's self cache the same way; its cross KV,
  read-only while generating, holds what admission projected (zeros for
  the token-only prompts the ``Server`` takes).  A bundle whose
  ``prefill_at`` raises ``NotImplementedError`` (found where the prefill
  step first runs: its warm-up before capture on a card, its first
  dispatch eagerly; ``supports_chunked_prefill``) is admitted by
  **decode-step replay**
  instead: each prompt token through the full-batch decode step (the
  decode graph's replay on a card; no prefill graph is captured), O(B·L)
  steps, warned once and counted in ``counters["decode_replay_prefills"]``.
* **On-device serve state** — sampling and stop detection run on the
  device; the only per-step device→host traffic is one packed ``(2, B)``
  next-token/stopped vector, fetched once into a pinned buffer.

* **Placement** — the Executor owns a :class:`~repro_torch.api.Runtime`:
  ``cfg.policy`` forces a policy (any ``parse_policy`` spelling), else the
  planner picks one for the serve phase (``Runtime.auto``; on the card
  the host policies are eligible, on the CPU only ``hbm_resident``).  The
  params and the KV cache (or the ``M`` layers' recurrent state) are
  realized under it.  A RESIDENT host placement (``kv=host``,
  ``params=host``) keeps the role in pinned host memory and hands the
  steps CUDA tensors over the card's mapped view of it: the same
  launches as ``hbm_resident``, captured in the same graphs, read and
  write host memory in place over PCIe.  A ``host:stream`` placement
  keeps the role in pinned host memory and the steps read it through a
  :class:`PlacedFeed`: each layer's weights and cache are staged into
  device slots window by window (``HostStream``, the copies on a copy
  stream inside the captured graphs), and each layer's new cache rows go
  back to host memory through the hand-written write-back kernel
  (``kernels/kv_stream.py``; in a prefill dispatch on a write-back stream
  of its own), an ``M`` layer's state whole, one copy a leaf.  An
  encoder-decoder's steps stream its decoder stack the same way
  (:class:`PlacedDecoderFeed`): each layer's cross KV is staged in and
  never copied back.  Under ``hbm_resident`` the steps take views of the
  resident trees and launch and copy exactly what they did before
  placement was realized.

* **Slot extract/insert** — preemption's device half: a victim's rows
  (``leaf[:, i]`` of every cache leaf: an ``F``/``S`` layer's KV, an ``M``
  layer's ``conv``/``ssm`` state) are copied out onto the planner-priced
  spill tier (pinned host memory on a card) and back into the same slot
  of the same buffers on promotion, so no graph is captured again.  Both
  wait for the device first (the compute stream, the ``HostStream`` copy
  and write-back streams), since under ``kv_host`` and ``kv=host`` the
  rows live in the host tree the steps stage from or read in place.
  Pinned spill rows are kept for the next spill (the first
  ``cudaHostAlloc`` of a slot costs far more than the copy); rows parked
  in device memory are freed on promotion.
* **Replan and evacuate** — :meth:`Executor.replan` re-places the live
  cache and params through :meth:`~repro_torch.api.Runtime.migrate_roles`
  (transient faults retried under ``MIGRATION_RETRY``) and
  :meth:`Executor.evacuate` moves the roles off a lost tier; either
  rebuilds the steps over the moved trees (:meth:`Executor._build_steps`:
  a new layer feed and, on a card, both graphs captured again).  The
  warm-ups before a capture run on the live state, so everything a step
  writes is copied before them and put back after, bit for bit.
* **Fault sites** — ``decode``, ``prefill`` and ``extract`` consult the
  runtime's :attr:`~repro_torch.api.Runtime.faults` before a replay or a
  copy (host-side checks; an injected stall sleeps inside the timed
  decode, where the watchdog sees it).
* **Build-time movement audit** (:meth:`Executor._audit_builds`, the
  reference's) — every build audits ``decode``, ``prefill`` and
  ``insert`` through :meth:`~repro_torch.api.Runtime.audit`: the cache
  comes back in its own storage, the params and a streamed source are
  left alone.  No step runs for the audit alone: on a card the decode and
  prefill audits run on the last warm-up before each capture; eagerly
  (the CPU, ``eager=True``) each step's first dispatch after a build is
  its audit, and the first restore after a build (:meth:`insert_slot`)
  audits the insert.  The reports land in :attr:`Executor.audit_reports`;
  under ``cfg.verify_donation`` an error raises
  :class:`~repro_torch.analysis.transfer_audit.DonationAliasError` there.
  The profiler's copy records are not read at a build (each replan would
  pay a profiler start): :meth:`Executor.audit_dispatch` does that for one
  replay or restore, for ``tools/audit.py --transfer-audit`` and
  ``chip_smoke.py``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import logging
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.transfer_audit import StepTarget
from repro_torch.api import Runtime
from repro_torch.core.faults import TransientFault
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import (
    HostStream,
    Placement,
    Role,
    donor_axes_for,
    host_empty,
    mapped_tree,
    parse_policy,
)
from repro_torch.core.warnings_registry import mark
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention, flash_prefill
from repro_torch.kernels.kv_stream import kv_write_back
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.runtime.retry import MIGRATION_RETRY, retry_call
from repro_torch.serve import sampling as sampling_mod
from repro_torch.serve.state import DeviceState, SlotTable, Uploader

log = logging.getLogger("repro_torch.serve.engine")

#: the kernel wrappers a serving step may launch, by kernel name
#: (``flash_attention``: an encoder-decoder's cross-attention)
KERNELS = {"decode_attention": flash_decode, "prefill_attention": flash_prefill,
           "flash_attention": flash_attention, "ssd_scan": ssd_scan,
           "kv_stream": kv_write_back}
#: eager runs on a side stream before a capture (PyTorch's CUDA-graph notes)
WARMUP_RUNS = 3


def _launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


class PlacedFeed(tf_mod.ResidentFeed):
    """The layer feed of a step under a policy that streams a role from
    host memory (see :class:`~repro_torch.models.transformer.ResidentFeed`
    for the interface).

    A streamed role's host tree is cut into the windows a step reads in
    order (``bundle.param_windows``, :func:`~repro_torch.models.transformer.
    param_windows`: the embedding, each layer, with Zamba-2's shared block
    again in each one that applies it, the tail; ``bundle.cache_windows``,
    :func:`~repro_torch.models.transformer.leaf_windows` of the cache: each
    layer) and staged through
    a :class:`~repro_torch.core.placement.HostStream` of two device slots.
    A resident role (in device memory, or RESIDENT in host memory through
    the card's mapped view) is fed as views, as :class:`ResidentFeed`
    does.  After a layer, the rows the step wrote into a staged cache
    window go back to the host cache through :func:`~repro_torch.kernels.
    kv_stream.kv_write_back`, one launch a layer; an ``M`` layer's
    (conv, ssm) state, which every step rewrites whole, goes back whole
    (:meth:`HostStream.write_back` of its entry, one copy a leaf on the
    copy stream, which the refill of its slot follows).  Where the layers bound the step
    (a prefill dispatch, up to 4 MB a layer at yi-6b's serving shape, with
    resident weights) it runs on the cache stream's write-back stream
    (:meth:`HostStream.writing_back`), beside the next layer's kernels and
    off the copy stream; the step's tail joins it
    (:meth:`HostStream.finish`), so ``pos`` and ``n`` are read before the
    step advances them.  Where the window copies bound it (a decode step,
    or any step that streams the weights) it runs in line on the compute
    stream, which waits for the next window there anyway: forking the
    compute stream once a layer made a captured step's window copies
    slower on the card (``PERF.md`` §6).  Every buffer is allocated here,
    once, so the steps can be captured.
    """

    def __init__(self, bundle, params, caches, *, stream_params: bool,
                 stream_kv: bool, batch_slots: int, device):
        super().__init__(params, caches)
        self.device = torch.device(device)
        self.batch_slots = batch_slots
        counts = [count for _, count, _ in bundle.cfg.stages()]
        #: global window index of each stage's first layer
        self._first = [sum(counts[:s]) for s in range(len(counts))]
        self.weights = (HostStream(bundle.param_windows(params), device)
                        if stream_params else None)
        self.kv = (HostStream(bundle.cache_windows(caches), device)
                   if stream_kv else None)
        self._consts: dict[int, torch.Tensor] = {}
        self._pos = self._n = None
        self._beside = False

    @staticmethod
    def written_back(window: dict) -> tuple[list[str], list[str]]:
        """The entries of a layer's cache window a step writes, as (rows:
        an attention layer's KV, whose new rows go back through the
        write-back kernel; whole: an ``M`` layer's state, which goes back
        whole)."""
        rows = [key for key, entry in window.items() if "k" in entry]
        return rows, [key for key in window if key not in rows]

    def _const(self, value: int) -> torch.Tensor:
        if value not in self._consts:
            self._consts[value] = torch.full((self.batch_slots,), value,
                                             dtype=torch.int32, device=self.device)
        return self._consts[value]

    def streams(self) -> dict[str, HostStream]:
        return {name: st for name, st in (("params", self.weights), ("kv_cache", self.kv))
                if st is not None}

    def buffers(self) -> list[torch.Tensor]:
        """Every tensor a step reads or writes besides the Executor's own:
        the staging slots and the host trees."""
        out = [b for st in self.streams().values() for b in st.buffers()]
        return out + tree_leaves(self.params) + tree_leaves(self.caches)

    def h2d_bytes(self) -> int:
        """Bytes one step copies from host memory (every window once)."""
        return sum(sum(st.window_bytes) for st in self.streams().values())

    def d2h_bytes(self) -> int:
        """Bytes one step copies back to host memory: each ``M`` layer's
        state whole (an attention layer's rows go back through the
        write-back kernel, which stores in place and makes no copy)."""
        if self.kv is None:
            return 0
        return sum(t.numel() * t.element_size() for window in self.kv.windows
                   for key in self.written_back(window)[1]
                   for t in tree_leaves(window[key]))

    def begin(self, pos, counts) -> None:
        self._pos = self._const(0) if pos is None else pos
        self._n = counts if torch.is_tensor(counts) else self._const(int(counts))
        # the write-backs go beside the layers where those bound the step:
        # more than one position a row (a prefill dispatch), resident weights
        self._beside = self.weights is None and (torch.is_tensor(counts) or counts > 1)
        for st in self.streams().values():
            st.begin()

    def top(self, part: str) -> dict:
        if self.weights is None:
            out = self.params
        elif part == "embed":
            return self.weights.window(0)
        else:
            out = self.weights.window(self.weights.n_windows - 1)
        if part == "tail":      # the step's last window: join the copies
            for st in self.streams().values():
                st.finish()
        return out

    def layer(self, stage: int, layer: int):
        lp, cache = super().layer(stage, layer)
        g = self._first[stage] + layer
        if self.weights is not None:
            lp = self.weights.window(1 + g)
        if self.kv is not None:
            cache = self.kv.window(g)
        return lp, cache

    def layer_done(self, stage: int, layer: int, cache) -> None:
        if self.kv is None:
            return
        g = self._first[stage] + layer
        host = self.kv.windows[g]
        # an M entry's state is rewritten whole every step: it goes back
        # whole, one copy a leaf; an attention entry's rows go back through
        # the write-back kernel
        rows, whole = self.written_back(cache)
        for key in whole:
            self.kv.write_back(g, key)
        if not rows:
            return
        with self.kv.writing_back(g) if self._beside else contextlib.nullcontext():
            for key in rows:
                kv_write_back(cache[key]["k"], cache[key]["v"], host[key]["k"],
                              host[key]["v"], self._pos, self._n)


class PlacedDecoderFeed(PlacedFeed, encdec_mod.DecoderFeed):
    """:class:`PlacedFeed` over an encoder-decoder's ``decoder`` stack
    (the layer views of a role that is not streamed come from
    :class:`~repro_torch.models.encdec.DecoderFeed`).  The windows are
    :func:`~repro_torch.models.encdec.param_windows` (the embedding, each
    decoder layer, the tail; the encoder's params, which no serving step
    reads, stay in the host tree and are never copied) and
    :func:`~repro_torch.models.encdec.cache_windows` (each layer's ``{"self",
    "cross"}``).  Only the self cache goes back, its new rows through the
    write-back kernel, one launch a layer: a serving step only reads the
    cross KV, so it is staged in and never copied back.  A prefill from
    position 0 (``encdec_prefill``) is not a serving step and is refused
    here: it reads the encoder's params and writes the cross cache."""

    @staticmethod
    def written_back(window: dict) -> tuple[list[str], list[str]]:
        return ["self"], []

    def begin(self, pos, counts) -> None:
        if pos is None:
            raise ValueError("encdec_prefill reads the encoder's params and writes "
                             "the cross cache: it does not run through a PlacedFeed, "
                             "whose steps stream the decoder and only read the cross KV")
        super().begin(pos, counts)


class Executor:
    """Decode/prefill dispatches over one model bundle.

    ``cfg`` is the scheduler's ``ServeConfig`` (the shape fields and
    ``policy`` are read here).  ``params`` must already lie on ``device``;
    they are realized under the policy (a streamed copy in pinned host
    memory under ``weights_stream``).  On a CUDA device the steps are
    captured as CUDA graphs here, unless ``eager``.
    """

    def __init__(self, bundle, cfg, params, device=None, *, eager: bool = False):
        self.bundle = bundle
        self.cfg = cfg
        self.device = resolve_device(device)
        B, C = cfg.batch_slots, max(int(cfg.prefill_chunk), 1)
        if cfg.policy is not None:
            self.runtime = Runtime(bundle, self.device, cfg.policy)
        else:
            self.runtime = Runtime.auto(
                bundle, self.device, phase="serve", batch_slots=B,
                max_len=cfg.max_len, prefill_chunk=C,
            )
            log.info("planner picked %s for %s (%d slots x %d ctx, prefill chunk %d)",
                     self.runtime.policy.name, bundle.cfg.name, B, cfg.max_len, C)
        # the injected-fault schedule lives on the runtime, so its realize
        # and migrate sites and this executor's sites consult one plan
        faults = getattr(cfg, "faults", None)
        if faults:
            self.runtime.faults = faults
        self.params = self.runtime.realize(params, Role.PARAMS)
        # a host-placed cache is made in host memory, never on the card
        caches = bundle.init_cache(
            B, cfg.max_len, device="cpu" if self.policy.placement(Role.KV_CACHE).on_host
            else self.device)
        self.caches = self.runtime.realize(caches, Role.KV_CACHE)
        # slot extract/insert slice the batch axis; every cache family
        # stacks layers first, batch second: verify rather than assume
        for leaf in tree_leaves(self.caches):
            if leaf.ndim < 2 or leaf.shape[1] != B:
                raise ValueError(
                    "cache leaf does not carry the batch on axis 1: shape "
                    f"{tuple(leaf.shape)} with batch_slots={B}")
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
        #: phase counters (tokens, wall seconds, dispatches, graph replays
        #: and captures) and lifecycle events
        self.counters = {
            "prefill_tokens": 0, "prefill_s": 0.0, "prefill_dispatches": 0,
            "decode_tokens": 0, "decode_s": 0.0, "decode_steps": 0,
            "decode_replays": 0, "prefill_replays": 0, "captures": 0,
            "replans": 0, "migrations": 0, "spill_s": 0.0, "restore_s": 0.0,
            "migration_retries": 0, "evacuations": 0, "decode_replay_prefills": 0,
        }
        self.graphed = self.device.type == "cuda" and not eager
        #: False once the bundle's ``prefill_at`` raised NotImplementedError
        #: (admission then replays the decode step)
        self.supports_chunked_prefill = True
        #: per graph, the kernel launches one replay makes (counted while
        #: capturing: the wrappers' counters tick at capture, not replay)
        self.graph_launches: dict[str, dict[str, int]] = {}
        #: the kernel launches the graph replays made, by kernel, across
        #: every build (each replay adds its graph's ``graph_launches``)
        self.replay_launches: collections.Counter = collections.Counter()
        self._graphs: dict[str, torch.cuda.CUDAGraph] = {}
        #: the newest build's movement audits of the steps, by step name
        #: ("decode", "prefill", "insert"; a step's appears once it ran)
        self.audit_reports: dict = {}
        #: True while a movement audit runs a step (a step it runs is not
        #: audited again inside it)
        self._auditing = False
        #: free spill-row trees in host memory: a preemption reuses one
        #: instead of allocating (pinning) anew; emptied when the host tier
        #: is lost
        self._spill_pool: list = []
        #: the last slot moves, newest last: ("spill" | "restore", "host" |
        #: "device" (where the parked rows lie), bytes, wall seconds)
        self.moves: collections.deque = collections.deque(maxlen=4096)
        #: the last migrations, newest last: (what, policy after, migrate
        #: wall seconds, rebuild wall seconds)
        self.migration_log: collections.deque = collections.deque(maxlen=256)
        self._build_steps(live=False)

    @property
    def policy(self):
        """The placement policy in force (the runtime's)."""
        return self.runtime.policy

    # -- the steps the graphs capture ---------------------------------------
    @torch.no_grad()
    def _decode_step(self, handed_back: dict | None = None) -> None:
        """One decode step over every slot, reading and writing only the
        fixed buffers and the caches.  ``handed_back`` receives the caches
        the model returned (the movement audit's in-place check)."""
        s = self.state
        logits, caches = self.bundle.decode_step(
            self.params, {"tokens": s["tokens"], "lengths": s["lengths"]},
            self.caches, feed=self.feed,
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
        if handed_back is not None:
            handed_back["caches"] = caches

    @torch.no_grad()
    def _prefill_step(self, handed_back: dict | None = None) -> None:
        """One chunked-prefill dispatch over the fixed prefill inputs
        (``handed_back``: as :meth:`_decode_step`)."""
        p = self.prefill_in
        _, caches = self.bundle.prefill_at(
            self.params, {"tokens": p["tokens"], "new_lens": p["new_lens"]},
            self.caches, p["offsets"], feed=self.feed,
        )
        if handed_back is not None:
            handed_back["caches"] = caches

    def _build_steps(self, *, live: bool = True) -> None:
        """(Re)build the steps for the trees and policy in force: the
        layer feed over the current params and caches and, on a card, both
        graphs captured over them (the counterpart of the reference's
        ``_build_steps``).  ``live``: rows may hold requests, so whatever
        the warm-ups write (the caches, the serve state's buffers, the
        prefill inputs, the packed result) is copied first and put back
        after them, bit for bit.  A failed capture raises; there is no
        fallback to the eager path."""
        stream_params = self.runtime.streamed(Role.PARAMS)
        stream_kv = self.runtime.streamed(Role.KV_CACHE)
        feed_cls = PlacedDecoderFeed if self.bundle.encdec else PlacedFeed
        #: the layer feed of the steps (None: views of resident trees)
        self.feed = (feed_cls(self.bundle, self.params, self.caches,
                              stream_params=stream_params, stream_kv=stream_kv,
                              batch_slots=self.cfg.batch_slots, device=self.device)
                     if stream_params or stream_kv else None)
        # the first decode step after a build pays set-up: the watchdog and
        # the runtime's step EWMA skip it
        self._steps_since_build = 0
        self.audit_reports = {}
        if not self.graphed:
            return
        for graph in self._graphs.values():
            graph.reset()
        self._graphs, self.graph_launches = {}, {}
        restore = self._snapshot() if live else None
        self._graphs["decode"] = self._capture("decode", self._decode_step, restore)
        if self.supports_chunked_prefill:
            try:
                self._graphs["prefill"] = self._capture("prefill", self._prefill_step,
                                                        restore)
            except NotImplementedError:
                # raised by the warm-up: the decode graph admits instead
                self.supports_chunked_prefill = False
        self._audit_builds()

    # -- build-time movement audit ----------------------------------------
    def audit_allowance(self, name: str) -> float:
        """Host<->device bytes one dispatch of ``name`` may copy: for a
        decode or prefill step the reference's Fig. 17 budget (one ``(B,
        1)`` token upload and one packed ``(2, B)`` fetch, ``3 · B · 4``)
        plus what a streamed placement's windows copy each way; for an
        insert the restored slot's bytes.  Mapped host memory read or
        written in place makes no copy and is not counted here."""
        if name == "insert":
            return float(self.slot_bytes())
        allow = 3 * self.cfg.batch_slots * 4
        if self.feed is not None:
            allow += self.feed.h2d_bytes() + self.feed.d2h_bytes()
        return float(allow)

    def _audit(self, name: str, step, *, profile: bool = False):
        """:meth:`Runtime.audit` of one run of ``step(handed_back)`` (which
        puts the caches it hands back under ``"caches"``) against the
        policy: the cache is written, in place where its placement allows;
        the params are only read; with ``profile`` on a card, the copies
        within :meth:`audit_allowance`."""
        def run() -> dict:
            handed_back: dict = {}
            step(handed_back)
            return handed_back

        self._auditing = True
        try:
            return self.runtime.audit(
                StepTarget(run, {"p": self.params, "caches": self.caches}, profile=profile),
                {"p": Role.PARAMS, "caches": Role.KV_CACHE}, donated={"caches"},
                host_bytes_allowed=self.audit_allowance(name),
                label=f"{name}:{self.bundle.cfg.name}:{self.policy.name}",
            )
        finally:
            self._auditing = False

    def _audit_builds(self) -> None:
        """Hold a graphed build to the audits of its last warm-ups
        (:meth:`_capture`; the reference's ``_audit_builds``): under
        ``cfg.verify_donation`` an error raises ``DonationAliasError``.
        An eager build audits each step on its first run instead
        (:meth:`_audit_first`)."""
        if getattr(self.cfg, "verify_donation", True):
            for report in self.audit_reports.values():
                report.raise_on_donation_errors()

    def _audit_first(self, name: str, step) -> None:
        """Run ``step(handed_back)`` as the build's movement audit of
        ``name``: its report lands in :attr:`audit_reports`, and under
        ``cfg.verify_donation`` an error raises ``DonationAliasError``."""
        report = self._audit(name, step)
        self.audit_reports[name] = report
        if getattr(self.cfg, "verify_donation", True):
            report.raise_on_donation_errors()

    def audit_dispatch(self, name: str, *, profile: bool = True, slot: int = 0,
                       rows=None):
        """The movement audit of one more dispatch: ``"decode"`` (one step,
        the packed fetch included), ``"prefill"`` (one dispatch of what the
        prefill inputs hold), a graph replay on a card, or ``"insert"``
        (:meth:`insert_slot` of ``rows`` into ``slot``).  With ``profile``
        on a card the dispatch runs inside a traced window and its copy
        records are held to the allowance.  Not part of a build: the tools
        call it."""
        if name == "decode":
            def step(out):
                self.decode()
                out["caches"] = self.caches
        elif name == "prefill":
            def step(out):
                self._run("prefill", self._prefill_step)
                out["caches"] = self.caches
        elif name == "insert":
            def step(out):
                self.insert_slot(slot, rows)
                out["caches"] = self.caches
        else:
            raise ValueError(f"no dispatch {name!r}: decode, prefill or insert")
        return self._audit(name, step, profile=profile)

    def _written(self) -> list[torch.Tensor]:
        """Every tensor a step writes that outlives it."""
        return (tree_leaves(self.caches) + list(self.state.buffers.values())
                + list(self.prefill_in.values()) + [self.out])

    def _snapshot(self):
        """Copy what the steps write; returns the function that puts it
        back (after the device is idle)."""
        self._sync()
        live = self._written()
        saved = [t.clone() for t in live]

        def restore() -> None:
            self._sync()
            for t, s in zip(live, saved):
                t.copy_(s)
            self._sync()
        return restore

    def _capture(self, name: str, step, restore=None) -> torch.cuda.CUDAGraph:
        """Warm ``step`` up on a side stream (the last warm-up is the
        build's movement audit of it, :meth:`_audit`), then capture it.

        A new Executor warms up on its all-idle state (rows that are
        inactive or take no new tokens), which changes nothing a request
        reads; a rebuild mid-serve passes ``restore``, which puts back what
        the warm-ups wrote before the capture.  A failed capture raises
        from here."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS - 1):
                step()
            # the last warm-up is the build's movement audit of the step
            self.audit_reports[name] = self._audit(name, step)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        if restore is not None:
            restore()
        # a graph the cyclic collector frees mid-capture (an unreachable
        # server's) would invalidate this capture: collect first, and keep
        # the collector off while capturing
        gc.collect()
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                step()
        finally:
            if enabled:
                gc.enable()
        after = _launch_counts()
        self.graph_launches[name] = {k: after[k] - before[k] for k in after
                                     if after[k] > before[k]}
        self.counters["captures"] += 1
        return graph

    def _sync(self) -> None:
        """Wait for every stream of the device: the compute stream and the
        host streams' copy and write-back streams (a step's forks)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, name: str, step) -> None:
        if self.graphed:
            self._graphs[name].replay()
            self.counters[f"{name}_replays"] += 1
            self.replay_launches.update(self.graph_launches[name])
        elif name in self.audit_reports or self._auditing:
            step()
        else:
            # an eager build's movement audit of a step is its first run
            self._audit_first(name, step)

    # -- decode ------------------------------------------------------------
    def decode(self) -> tuple[np.ndarray, np.ndarray]:
        """One decode step over every slot, advancing the device state.

        Returns ``(next_tokens (B,), stopped (B,) bool)``; the packed
        result is the step's only device→host transfer.  An injected
        ``decode`` fault fires before the replay, so a recovery path sees
        the state before the step.
        """
        if self.runtime.faults:
            self.runtime.faults.check("decode")
        t0 = time.perf_counter()
        self._run("decode", self._decode_step)
        # the one fetch per step, the packed (2, B) vector: the serve path's
        # one sanctioned blocking fetch (analysis.lint)
        host = self.out
        if self._out_host is not None:
            host = self._out_host
            host.copy_(self.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()  # repro: lint-disable=blocking-transfer-in-hot-path
        out = host.numpy().copy()  # repro: lint-disable=blocking-transfer-in-hot-path
        dt = time.perf_counter() - t0
        self.counters["decode_s"] += dt
        self.counters["decode_steps"] += 1
        self._steps_since_build += 1
        if self._steps_since_build > 1:      # the first after a build pays set-up
            self.runtime.observe_decode_step(self.cfg.batch_slots, self.cfg.max_len, dt)
        return out[0], out[1].astype(bool)

    @property
    def measured_step_s(self) -> float | None:
        """The runtime's EWMA of the decode step's wall time under the
        policy in force, from the second step after a build on (None
        before)."""
        return self.runtime.measured_step_s(self.cfg.batch_slots, self.cfg.max_len)

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
        if self.supports_chunked_prefill:
            try:
                self._chunked_prefill(new, table)
            except NotImplementedError:
                # eagerly the bundle refuses at its first dispatch, before
                # any row's length advanced
                if self.counters["prefill_dispatches"]:
                    raise
                self.supports_chunked_prefill = False
        if not self.supports_chunked_prefill:
            self._replay_prefill(new, table)
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
        self.stage_prefill(tokens, new_lens, offsets)
        self._run("prefill", self._prefill_step)
        self.counters["prefill_dispatches"] += 1

    def stage_prefill(self, tokens: np.ndarray, new_lens: np.ndarray,
                      offsets: np.ndarray) -> None:
        """Upload one dispatch's inputs into the fixed prefill buffers
        (queued on the current stream), without dispatching."""
        self._prefill_up.put({"tokens": tokens, "new_lens": new_lens, "offsets": offsets})

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

    def _replay_prefill(self, new, table) -> None:
        """Admission for a bundle whose ``prefill_at`` raises
        ``NotImplementedError``: each prompt token (the last withheld, as
        in :meth:`prefill`) through the full-batch decode step, with every
        row inactive so no length or token advances on the device; the
        table's ``lengths`` advance here.  O(B·L) steps, correctness only:
        warned once, counted per admitted request.  A row the step also
        writes at its fill position gets that slot rewritten by its own
        next step, as in the reference."""
        if mark(f"decode_replay:{self.bundle.cfg.name}"):
            log.warning(
                "%s has no chunked prefill (prefill_at raised NotImplementedError): "
                "admission falls back to O(B*L) decode-step replay, correctness "
                "only; counted in stats()['decode_replay_prefills']",
                self.bundle.cfg.name)
        self.counters["decode_replay_prefills"] += len(new)
        B = self.cfg.batch_slots
        idle = SlotTable(B).mirrors()
        for i, prompt in new:
            for t in range(len(prompt) - 1):
                toks = np.zeros((B, 1), np.int32)
                toks[i, 0] = prompt[t]
                self.state.put({**idle, "tokens": toks, "lengths": table.lengths})
                self._run("decode", self._decode_step)
                table.lengths[i] += 1

    # -- preemption: slot spill / restore ---------------------------------
    def slot_bytes(self) -> int:
        """Bytes of one cache slot's rows — what a preemption spill moves
        (each way)."""
        B = self.cfg.batch_slots
        return sum(t.numel() * t.element_size() // B for t in tree_leaves(self.caches))

    def summable(self, rows):
        """Parked rows as the device reads them, for a checksum: pinned
        host rows on a card through the card's mapped view of them (summed
        on the card over PCIe, no copy); otherwise the rows themselves.
        The rows stay where they were parked until promoted, so the sums
        at spill and at promotion run on the same device over the same
        bytes."""
        leaves = tree_leaves(rows)
        arena = getattr(leaves[0], "_host_arena", None)
        return mapped_tree(rows) if arena is not None and arena.pinned else rows

    def _spill_rows(self, spill_to: Placement):
        """A free tree shaped like one slot's rows (every leaf ``(L, 1,
        ...)``) on ``spill_to``: pinned host memory for the host tier (an
        arena, checked pinned on a card; reused from the pool when one is
        free), the device's memory for ``HBM``."""
        if spill_to.tier not in (MemoryTier.HOST, MemoryTier.HBM):
            donor_axes_for(None, spill_to.tier)      # raises: no donor axis
        if spill_to.on_host and self._spill_pool:
            return self._spill_pool.pop()
        proto = tree_map(lambda t: t[:, :1], self.caches)
        if spill_to.on_host:
            return host_empty(proto, self.device)
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=self.device),
                        proto)

    def extract_slot(self, i: int, spill_to: Placement):
        """Copy slot ``i``'s cache rows out onto ``spill_to`` (the
        planner-priced spill tier) after the device's last work, and wait
        for the copies: the rows are consistent when this returns.  The
        cache itself is not touched.  Counted in ``spill_s``."""
        if self.runtime.faults:
            self.runtime.faults.check("extract")
        t0 = time.perf_counter()
        rows = self._spill_rows(spill_to)
        self._sync()
        for dst, src in zip(tree_leaves(rows), tree_leaves(self.caches)):
            dst.copy_(src[:, i:i + 1], non_blocking=True)
        self._sync()
        dt = time.perf_counter() - t0
        self.counters["spill_s"] += dt
        self.moves.append(("spill", "host" if spill_to.on_host else "device",
                           self.slot_bytes(), dt))
        return rows

    def insert_slot(self, i: int, rows) -> None:
        """Copy parked rows back into slot ``i`` of the same cache buffers
        (promotion), in place, so the captured graphs stay valid; the
        move is value for value.  Rows parked in host memory for a card
        must be pinned (a pageable spill raises).  Host rows return to the
        spill pool.  Counted in ``restore_s``."""
        t0 = time.perf_counter()
        leaves = tree_leaves(rows)
        host = getattr(leaves[0], "_host_arena", None) is not None
        if self.device.type == "cuda" and not all(
                t.device.type == "cuda" or t.is_pinned() for t in leaves):
            raise RuntimeError("spilled rows in pageable host memory: a spill to host "
                               "memory must land pinned")
        self._sync()
        if "insert" in self.audit_reports or self._auditing:
            self._insert_rows(i, rows)
        else:
            # the build's movement audit of the insert is its first restore
            self._audit_first("insert", lambda out: out.update(
                caches=self._insert_rows(i, rows)))
        self._sync()
        if host:
            self._spill_pool.append(rows)
        dt = time.perf_counter() - t0
        self.counters["restore_s"] += dt
        self.moves.append(("restore", "host" if host else "device", self.slot_bytes(), dt))

    def _insert_rows(self, i: int, rows):
        """Copy ``rows`` into slot ``i`` of every cache leaf, in place;
        returns the caches."""
        for dst, src in zip(tree_leaves(self.caches), tree_leaves(rows)):
            dst[:, i:i + 1].copy_(src, non_blocking=True)
        return self.caches

    # -- live re-placement -------------------------------------------------
    def _adopt(self, trees: dict) -> None:
        self.caches = trees[Role.KV_CACHE]
        self.params = trees[Role.PARAMS]

    def _on_retry(self, attempt, err, delay) -> None:
        self.counters["migration_retries"] += 1

    def _rebuild_after(self, what: str, t0: float) -> None:
        """Rebuild the steps over migrated trees; log the migration's and
        the rebuild's wall seconds."""
        t1 = time.perf_counter()
        self._build_steps()
        self.migration_log.append((what, self.policy.name, t1 - t0,
                                   time.perf_counter() - t1))

    def replan(self, policy=None, *, force: bool = False, occupancy: float = 1.0) -> bool:
        """Re-place the live KV cache (and params) mid-serve.

        With ``policy=None``, re-runs the planner's serve pricing against
        the live cache ``occupancy``; with an explicit ``policy`` (any
        ``parse_policy`` spelling), adopts it.  When the target differs
        from the policy in force (by placements, not names), the device's
        work is drained, the roles whose placement changed move through
        :meth:`~repro_torch.api.Runtime.migrate_roles` (value for value;
        transient faults retried under ``MIGRATION_RETRY``) and the steps
        are rebuilt over the moved trees, both graphs captured again with
        the live rows kept as they were.  Returns True iff a migration
        happened.  On one card this really moves trees, where the
        reference's ``mesh=None`` returns False.
        """
        rt = self.runtime
        old = rt.policy
        self.counters["replans"] += 1
        if policy is None:
            rt.plan_phase("serve", batch_slots=self.cfg.batch_slots,
                          max_len=self.cfg.max_len, prefill_chunk=self.cfg.prefill_chunk,
                          kv_utilization=occupancy, log_table=False)
            target = rt.policy
        else:
            target = parse_policy(policy)
        rt.policy = old
        if all(target.placement(r) == old.placement(r) for r in Role) and not force:
            return False
        self._sync()
        t0 = time.perf_counter()
        trees = {Role.KV_CACHE: self.caches, Role.PARAMS: self.params}
        try:
            moved = retry_call(
                lambda: rt.migrate_roles(trees, target, force=force),
                retry_on=(TransientFault,), policy=MIGRATION_RETRY,
                label=f"replan {old.name}->{target.name}",
                seed=self.counters["replans"], on_retry=self._on_retry,
            )
        except BaseException:
            # a role that landed lives only in its new tree: adopt what
            # moved, and rebuild only if something did
            self._adopt(trees)
            if rt.policy is not old:
                self._build_steps()
            raise
        self._adopt(trees)
        self._rebuild_after("replan", t0)
        self.counters["migrations"] += 1
        log.info("replan: migrated %s -> %s (%s) at occupancy %.0f%%", old.name,
                 target.name, ",".join(r.value for r in moved) or "forced no-op",
                 100 * occupancy)
        return True

    def evacuate(self, tier, *, occupancy: float = 1.0) -> list[Role]:
        """Serve-side tier loss: drain the device, delegate to
        :meth:`~repro_torch.api.Runtime.evacuate` (the planner's re-pick
        with the lost tier excluded; transient faults retried under the
        migration budget), adopt the moved trees and rebuild the steps.
        Returns the roles that moved.  On one card a role on a lost
        ``host`` tier really moves to the card's memory."""
        rt = self.runtime
        old = rt.policy
        self._sync()
        t0 = time.perf_counter()
        trees = {Role.KV_CACHE: self.caches, Role.PARAMS: self.params}
        try:
            _, moved = retry_call(
                lambda: rt.evacuate(
                    tier, trees, phase="serve", batch_slots=self.cfg.batch_slots,
                    max_len=self.cfg.max_len, prefill_chunk=self.cfg.prefill_chunk,
                    kv_utilization=occupancy),
                retry_on=(TransientFault,), policy=MIGRATION_RETRY,
                label=f"evacuate {tier}", seed=self.counters["evacuations"],
                on_retry=self._on_retry,
            )
        except BaseException:
            self._adopt(trees)
            if rt.policy is not old:
                self._build_steps()
            raise
        self._adopt(trees)
        self.counters["evacuations"] += 1
        if MemoryTier.HOST in rt.lost_tiers:
            self._spill_pool.clear()        # no spill lands there again
        if moved:
            self._rebuild_after("evacuate", t0)
            self.counters["migrations"] += 1
        return moved
