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
  stream of the Executor's own (which also builds every kernel and sets
  its shared-memory attributes) and captured on it, once per Executor, at (``batch_slots``,
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

* **A ``data`` x ``model`` mesh** (ported with ROADMAP A10b, serving
  half; the reference's ``Executor(..., mesh)`` under ``DEFAULT_RULES``):
  each rank holds its shards of the params (``Runtime.shard``, then
  ``Runtime.realize``) and of the cache, made at their local shapes from
  ``Runtime.specs(Role.KV_CACHE, cache_defs)``, and its steps run on its
  rows of the slots (``batch`` on ``data``: :func:`~repro_torch.models.
  sharding.batch_block`; where ``data`` does not divide the slots every
  rank runs every row) and its query heads, kv heads, ``d_ff`` columns
  and vocab rows (Megatron over ``model``, :mod:`repro_torch.models.
  layers`).  The serve state stays global on every rank, as the
  reference's is replicated: the decode step samples its rows, gathers
  the packed ``(2, rows)`` result over ``data`` into ``out`` and advances
  the whole state from it, so every rank's scheduler sees the same tokens
  and one fetch a step remains.  The collectives (an all-reduce of each
  layer's attention and MLP outputs and of the embedding, the logits'
  gather over ``model``, the ``data`` gather) are captured in the graphs;
  each group ran one collective eagerly first (:meth:`Executor.
  _warm_groups`).  A slot's rows live on the ``data`` rank that owns it
  (:func:`~repro_torch.models.sharding.slot_owner`): a spill copies them
  there and a non-owner holds nothing.  ``one_rank=True`` splits over
  one-rank axes too, so one card runs every collective (the counterpart
  of ``make_train_step(one_rank=)``).  Decisions the serving loop takes
  on a rank's own clock or calibration are taken on rank 0 and broadcast
  (:class:`Ranks`).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import logging
import math
import time

import numpy as np
import torch
import torch.distributed as dist

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
from repro_torch.models.sharding import (
    COLLECTIVES,
    batch_block,
    gather_dim,
    mesh_shape,
    slot_owner,
    spec_axes,
    spec_for,
    tree_leaves,
    tree_map,
    unrealized_rules,
    use_sharding,
)
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


#: the mesh axes serving realizes (the reference's launcher builds no other)
SERVE_AXES = ("data", "model")


def check_serve_mesh(bundle, mesh, rules=None) -> None:
    """Raise ``NotImplementedError`` by name for a mesh the port does not
    serve on: a donor axis (the peer and remote placements, ROADMAP A10c)
    or another axis than ``data``/``model``; rules that split a logical
    axis over a mesh axis of several ranks the layers do not realize it
    on (``seq``, ``kv_seq``, ``embed``: ROADMAP A10b, rest); a ``model``
    axis of several ranks over MoE, SSM, MLA, the encoder-decoder or the
    VLM (:meth:`~repro_torch.models.model_zoo.ModelBundle.check_model_axis`)."""
    axes = mesh_shape(mesh)
    other = {a: n for a, n in axes.items() if a not in SERVE_AXES}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: serving takes a (data, model) mesh; donor axes (the "
            "peer and remote placements) are ROADMAP A10c")
    odd = unrealized_rules(rules, mesh)
    if odd:
        raise NotImplementedError(
            f"rules {odd} over mesh axes {axes}: the port serves the slots over 'data' "
            "and heads, kv_heads, d_ff and vocab over 'model' only (ROADMAP A10b, rest)")
    bundle.check_model_axis(axes.get("model", 1))


class Ranks:
    """How the ranks of a serving mesh agree.  Every rank runs the same
    loop on the same requests and so takes the same decisions, but a
    decision that reads what only one rank sees (its clock, its measured
    step EWMA, its calibration) is taken on the mesh's first rank and
    broadcast (:meth:`share`), and a verdict each rank takes on its own
    rows (a spill's checksum, on its owner) is reduced (:meth:`all_ok`):
    ranks that decided apart would deadlock in the next collective.  Both
    run over the mesh's axis groups in turn, so a mesh over some of the
    processes' ranks agrees among its own.  One rank (no mesh, or a mesh
    of one) shares nothing."""

    def __init__(self, mesh, device):
        sizes = mesh_shape(mesh)
        self.device = device
        self.many = math.prod(sizes.values()) > 1 if sizes else False
        #: this rank's index on the mesh, row-major (0 without one)
        self.rank = 0
        for axis, n in sizes.items():
            self.rank = self.rank * n + mesh.get_local_rank(axis)
        # the minor axis first: then the major one spreads what its first
        # coordinate's ranks hold
        self._groups = [mesh.get_group(a) for a, n in reversed(sizes.items()) if n > 1]

    def share(self, value):
        """The first rank's ``value`` (anything pickle takes), on every
        rank."""
        box = [value]
        for group in self._groups:
            dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                       group=group, device=self.device)
        return box[0]

    def pick(self, value, choices):
        """The first rank's ``value``, one of ``choices``, on every rank:
        its index in one one-element broadcast a group (no pickle, one
        collective where :meth:`share` takes two)."""
        if not self.many:
            return value
        index = torch.tensor([choices.index(value)], device=self.device)
        for group in self._groups:
            dist.broadcast(index, src=dist.get_global_rank(group, 0), group=group)
        return choices[int(index.item())]

    def all_ok(self, ok: bool) -> bool:
        """True on every rank iff ``ok`` on every rank."""
        if not self.many:
            return ok
        flag = torch.tensor([int(ok)], device=self.device)
        for group in self._groups:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        return bool(flag.item())


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

    ``cfg`` is the scheduler's ``ServeConfig`` (the shape fields,
    ``policy`` and ``rules`` are read here).  ``params`` must already lie
    on ``device``; they are realized under the policy (a streamed copy in
    pinned host memory under ``weights_stream``), on a ``mesh`` this
    rank's shards of them (``params`` are the full weights, as every rank
    drew them).  On a CUDA device the steps are captured as CUDA graphs
    here, unless ``eager``.  ``one_rank``: on a mesh, split over its
    one-rank axes too (see the module's docstring).
    """

    def __init__(self, bundle, cfg, params, device=None, *, eager: bool = False,
                 mesh=None, one_rank: bool = False):
        self.bundle = bundle
        self.cfg = cfg
        self.device = resolve_device(device)
        B, C = cfg.batch_slots, max(int(cfg.prefill_chunk), 1)
        #: the mesh, the rule overlay and the one-rank switch the steps
        #: install (``use_sharding``)
        self.mesh, self.rules, self.one_rank = mesh, getattr(cfg, "rules", None), one_rank
        if mesh is not None:
            check_serve_mesh(bundle, mesh, self.rules)
        self.ranks = Ranks(mesh, self.device)
        if cfg.policy is not None:
            self.runtime = Runtime(bundle, self.device, cfg.policy, mesh=mesh,
                                   rules=self.rules)
        else:
            self.runtime = Runtime.auto(
                bundle, self.device, phase="serve", batch_slots=B,
                max_len=cfg.max_len, prefill_chunk=C, mesh=mesh, rules=self.rules,
                log_table=self.ranks.rank == 0,
            )
            # the pick reads this rank's calibration: rank 0's serves them all
            self.runtime.policy = self.ranks.share(self.runtime.policy)
            if self.ranks.rank == 0:
                log.info("planner picked %s for %s (%d slots x %d ctx, prefill chunk %d)",
                         self.runtime.policy.name, bundle.cfg.name, B, cfg.max_len, C)
        # the injected-fault schedule lives on the runtime, so its realize
        # and migrate sites and this executor's sites consult one plan
        faults = getattr(cfg, "faults", None)
        if faults:
            self.runtime.faults = faults
        self.params = self.runtime.realize(self.runtime.shard(params, Role.PARAMS),
                                           Role.PARAMS)
        #: this rank's block of the slots, rows ``self.rows`` (every row
        #: where the slots are not split over ``data``)
        self.block, self.blocks = batch_block(B, mesh, self.rules)
        n = B // self.blocks
        self.rows = slice(self.block * n, (self.block + 1) * n)
        #: does the decode step gather its rows' results over ``data``?
        self.gathers_data = "data" in spec_axes(spec_for((B,), ("batch",), mesh, self.rules)) \
            and (self.blocks > 1 or one_rank)
        #: the cache's specs over the mesh (None without one)
        self.cache_specs = self.runtime.specs(Role.KV_CACHE, bundle.cache_defs(B, cfg.max_len))
        # a host-placed cache is made in host memory, never on the card,
        # and a rank makes its shards at their local shapes
        local = {} if mesh is None else {"specs": self.cache_specs, "mesh": mesh}
        caches = bundle.init_cache(
            B, cfg.max_len, device="cpu" if self.policy.placement(Role.KV_CACHE).on_host
            else self.device, **local)
        self.caches = self.runtime.realize(caches, Role.KV_CACHE)
        # slot extract/insert slice the batch axis; every cache family
        # stacks layers first, batch second: verify rather than assume
        for leaf in tree_leaves(self.caches):
            if leaf.ndim < 2 or leaf.shape[1] != n:
                raise ValueError(
                    "cache leaf does not carry the batch on axis 1: shape "
                    f"{tuple(leaf.shape)} with {n} of batch_slots={B} on this rank")
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
        #: the stream the steps warm up and are captured on, drawn at each
        #: build (:meth:`_capture_stream`)
        self._stream = None
        #: False once the bundle's ``prefill_at`` raised NotImplementedError
        #: (admission then replays the decode step)
        self.supports_chunked_prefill = True
        #: per graph, the kernel launches one replay makes (counted while
        #: capturing: the wrappers' counters tick at capture, not replay)
        self.graph_launches: dict[str, dict[str, int]] = {}
        #: per graph, the collectives one replay runs, by kind (counted
        #: while capturing, :data:`~repro_torch.models.sharding.COLLECTIVES`)
        self.graph_collectives: dict[str, dict[str, int]] = {}
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
        #: the last slot moves, newest last: ("spill" | "restore" | "carry"
        #: (parked rows received from another data rank), "host" | "device"
        #: (where the parked rows lie), bytes, wall seconds)
        self.moves: collections.deque = collections.deque(maxlen=4096)
        #: the last migrations, newest last: (what, policy after, migrate
        #: wall seconds, rebuild wall seconds)
        self.migration_log: collections.deque = collections.deque(maxlen=256)
        if self.graphed and mesh is not None:
            self._warm_groups()
        self._build_steps(live=False)

    @property
    def policy(self):
        """The placement policy in force (the runtime's)."""
        return self.runtime.policy

    # -- the steps the graphs capture ---------------------------------------
    def _sharding(self):
        """The mesh, rules and one-rank switch the layers read while a step
        runs (nothing without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_sharding(self.mesh, self.rules, one_rank=self.one_rank)

    def _warm_groups(self) -> None:
        """One collective on each of the mesh's groups, eagerly: a
        communicator's first collective sets it up and cannot be captured
        in a CUDA graph."""
        for axis in mesh_shape(self.mesh):
            flag = torch.zeros(1, device=self.device)
            dist.all_reduce(flag, group=self.mesh.get_group(axis))
        self._sync()

    @torch.no_grad()
    def _decode_step(self, handed_back: dict | None = None) -> None:
        """One decode step over this rank's slots, reading and writing only
        the fixed buffers and the caches; on a ``data`` split the packed
        results of every rank's rows are gathered into ``out``, and every
        rank advances the whole serve state from them.  ``handed_back``
        receives the caches the model returned (the movement audit's
        in-place check)."""
        s = self.state
        mine = {k: t[self.rows] for k, t in s.buffers.items()}
        with self._sharding():
            logits, caches = self.bundle.decode_step(
                self.params, {"tokens": mine["tokens"], "lengths": mine["lengths"]},
                self.caches, feed=self.feed,
            )
        # greedy rows (temp == 0) take the plain argmax
        next_tok = sampling_mod.sample_tokens(logits, mine)         # (rows,)
        stopped = sampling_mod.hit_stop(next_tok, mine["stop"])
        packed = torch.stack([next_tok, (stopped & mine["active"]).to(torch.int32)])
        if self.gathers_data:
            packed = gather_dim(packed, 1, self.mesh.get_group("data"), self.blocks)
        self.out.copy_(packed)
        # inactive rows keep their token/length so idle slots and freshly
        # prefilled slots ride through untouched
        active = s["active"]
        s["tokens"].copy_(torch.where(active[:, None], self.out[0][:, None],
                                      s["tokens"]))
        s["lengths"].add_(active.to(torch.int32))
        if handed_back is not None:
            handed_back["caches"] = caches

    @torch.no_grad()
    def _prefill_step(self, handed_back: dict | None = None) -> None:
        """One chunked-prefill dispatch over this rank's rows of the fixed
        prefill inputs (``handed_back``: as :meth:`_decode_step`)."""
        p = self.prefill_in
        with self._sharding():
            _, caches = self.bundle.prefill_at(
                self.params, {"tokens": p["tokens"][self.rows],
                              "new_lens": p["new_lens"][self.rows]},
                self.caches, p["offsets"][self.rows], feed=self.feed,
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
                              batch_slots=self.rows.stop - self.rows.start,
                              device=self.device)
                     if stream_params or stream_kv else None)
        # the first decode step after a build pays set-up: the watchdog and
        # the runtime's step EWMA skip it
        self._steps_since_build = 0
        self.audit_reports = {}
        if not self.graphed:
            return
        for graph in self._graphs.values():
            graph.reset()
        self._graphs, self.graph_launches, self.graph_collectives = {}, {}, {}
        restore = self._snapshot() if live else None
        self._stream = self._capture_stream()
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

    def _host_streams(self) -> dict[str, torch.cuda.Stream]:
        """The copy and write-back streams of the feed's host streams."""
        out = {}
        for role, st in (self.feed.streams().items() if self.feed is not None else ()):
            out[f"{role} copy"], out[f"{role} write-back"] = st._copy_stream, st._wb_stream
        return out

    def _capture_stream(self) -> torch.cuda.Stream:
        """A stream of PyTorch's pool that none of the feed's host streams
        is.  ``torch.cuda.Stream()`` hands the pool's 32 streams a device
        out in turn, and ``torch.cuda.graph``'s default capture stream is
        one of them: a write-back or copy stream drawn later could be it,
        and its work would be captured in line with the layers."""
        taken = {s.cuda_stream for s in self._host_streams().values()}
        for _ in range(2 * len(taken) + 1):
            stream = torch.cuda.Stream(self.device)
            if stream.cuda_stream not in taken:
                return stream
        raise RuntimeError(f"no stream of the pool besides the host streams' {len(taken)}")

    def _check_streams(self) -> None:
        """Raise unless the capture stream and each host stream's copy and
        write-back streams are distinct streams: a copy or write-back on
        the stream a step is captured on runs in line with the layers."""
        held = {"capture": self._stream, **self._host_streams()}
        ids = collections.Counter(s.cuda_stream for s in held.values())
        shared = [name for name, s in held.items() if ids[s.cuda_stream] > 1]
        if shared:
            raise RuntimeError(f"streams {shared} are one stream: the steps would run "
                               "their copies or write-backs in line")

    def _capture(self, name: str, step, restore=None) -> torch.cuda.CUDAGraph:
        """Warm ``step`` up on the executor's own stream (the last warm-up
        is the build's movement audit of it, :meth:`_audit`), then capture
        it there.

        A new Executor warms up on its all-idle state (rows that are
        inactive or take no new tokens), which changes nothing a request
        reads; a rebuild mid-serve passes ``restore``, which puts back what
        the warm-ups wrote before the capture.  A failed capture raises
        from here."""
        dev = self.device
        self._check_streams()
        side = self._stream
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
        collectives = collections.Counter(COLLECTIVES)
        graph = torch.cuda.CUDAGraph()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                step()
        finally:
            if enabled:
                gc.enable()
        after = _launch_counts()
        self.graph_launches[name] = {k: after[k] - before[k] for k in after
                                     if after[k] > before[k]}
        self.graph_collectives[name] = dict(COLLECTIVES - collectives)
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
        """Bytes of one cache slot's rows on its owner — what a preemption
        spill moves (each way)."""
        return sum(t.numel() * t.element_size() // t.shape[1] for t in tree_leaves(self.caches))

    def owns(self, i: int) -> int | None:
        """Slot ``i``'s row in this rank's cache, or None when another
        ``data`` rank holds it (:func:`~repro_torch.models.sharding.
        slot_owner`)."""
        block, row = slot_owner(i, self.cfg.batch_slots, self.blocks)
        return row if block == self.block else None

    def summable(self, rows):
        """Parked rows as the device reads them, for a checksum: pinned
        host rows on a card through the card's mapped view of them (summed
        on the card over PCIe, no copy); otherwise the rows themselves
        (None on a rank that does not own the slot).  The rows stay where
        they were parked until promoted, so the sums at spill and at
        promotion run on the same device over the same bytes."""
        if rows is None:
            return None
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
        cache itself is not touched.  Counted in ``spill_s``.  On a
        ``data`` split only the rank that owns the slot copies; the others
        return None (they hold nothing of it)."""
        if self.runtime.faults:
            self.runtime.faults.check("extract")
        row = self.owns(i)
        if row is None:
            return None
        t0 = time.perf_counter()
        rows = self._spill_rows(spill_to)
        self._sync()
        for dst, src in zip(tree_leaves(rows), tree_leaves(self.caches)):
            dst.copy_(src[:, row:row + 1], non_blocking=True)
        self._sync()
        dt = time.perf_counter() - t0
        self.counters["spill_s"] += dt
        self.moves.append(("spill", "host" if spill_to.on_host else "device",
                           self.slot_bytes(), dt))
        return rows

    def carry_rows(self, rows, spilled_from: int, i: int):
        """Rows parked from slot ``spilled_from`` (``rows`` on the rank that
        held it, None elsewhere), on the rank that holds slot ``i``: where
        another ``data`` rank holds ``i``, each leaf goes there over the
        ``data`` group (a device tensor on a card: NCCL sends from the
        card), and the parking rank's host rows return to its spill pool.
        Every rank calls it; what a rank gets is what :meth:`insert_slot`
        takes from it."""
        src, _ = slot_owner(spilled_from, self.cfg.batch_slots, self.blocks)
        dst, _ = slot_owner(i, self.cfg.batch_slots, self.blocks)
        if src == dst or self.block not in (src, dst):
            return rows if self.block == src else None
        group = self.mesh.get_group("data")
        self._sync()
        if self.block == src:
            peer = dist.get_global_rank(group, dst)
            for t in tree_leaves(rows):
                dist.send(t.to(self.device).contiguous(), dst=peer, group=group)
            if getattr(tree_leaves(rows)[0], "_host_arena", None) is not None:
                self._spill_pool.append(rows)
            return None
        peer = dist.get_global_rank(group, src)
        t0 = time.perf_counter()
        got = tree_map(lambda t: torch.empty(t[:, :1].shape, dtype=t.dtype,
                                             device=self.device), self.caches)
        for t in tree_leaves(got):
            dist.recv(t, src=peer, group=group)
        self.moves.append(("carry", "device", self.slot_bytes(), time.perf_counter() - t0))
        return got

    def insert_slot(self, i: int, rows) -> None:
        """Copy parked rows back into slot ``i`` of the same cache buffers
        (promotion), in place, so the captured graphs stay valid; the
        move is value for value.  Rows parked in host memory for a card
        must be pinned (a pageable spill raises).  Host rows return to the
        spill pool.  Counted in ``restore_s``.  ``rows`` None (a rank that
        does not own the slot) copies nothing."""
        if rows is None:
            return
        row = self.owns(i)
        t0 = time.perf_counter()
        leaves = tree_leaves(rows)
        host = getattr(leaves[0], "_host_arena", None) is not None
        if self.device.type == "cuda" and not all(
                t.device.type == "cuda" or t.is_pinned() for t in leaves):
            raise RuntimeError("spilled rows in pageable host memory: a spill to host "
                               "memory must land pinned")
        self._sync()
        if "insert" in self.audit_reports or self._auditing:
            self._insert_rows(row, rows)
        else:
            # the build's movement audit of the insert is its first restore
            self._audit_first("insert", lambda out: out.update(
                caches=self._insert_rows(row, rows)))
        self._sync()
        if host:
            self._spill_pool.append(rows)
        dt = time.perf_counter() - t0
        self.counters["restore_s"] += dt
        self.moves.append(("restore", "host" if host else "device", self.slot_bytes(), dt))

    def _insert_rows(self, row: int, rows):
        """Copy ``rows`` into row ``row`` of every cache leaf, in place;
        returns the caches."""
        for dst, src in zip(tree_leaves(self.caches), tree_leaves(rows)):
            dst[:, row:row + 1].copy_(src, non_blocking=True)
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
            # the pick reads this rank's calibration: rank 0's moves them all
            target = self.ranks.share(rt.policy)
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
