"""A step's work counted op by op: FLOPs and bytes on the ``meta`` device.

Counterpart of ``repro/core/hlo_analysis.py``.  The reference reads its
step's compiled XLA HLO; the port has no HLO.  It runs the step once
under a ``TorchDispatchMode`` on ``meta`` tensors, which carry shapes and
dtypes and compute nothing, and counts every aten op that reaches the
dispatcher (forward, and backward when the step differentiates):

* ``flops`` — products only, as the reference counts ``dot`` and
  ``convolution`` only (``hlo_analysis.py:538-626``): ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` (their ``out_dtype`` overloads included, which
  the bfloat16 MLA products take on a card) and ``convolution``, with
  ``torch.utils.flop_counter``'s formulas (2·M·N·K a product; a
  convolution 2 · output elements · input channels per group · kernel
  taps; a transposed one counted as its forward).
* ``hbm_bytes`` — each op's tensor inputs read once and its outputs
  written once.  A view moves nothing.  An in-place index/scatter update
  (``index_put_``, ``index_copy_``, ``scatter_`` …) reads its update and
  indices and writes only the update, and a ``copy_`` into a slice writes
  the slice, as the reference's refinements charge an updated slice, not
  the buffer (``hlo_analysis.py:628-750``).

  This count is per aten op and unfused: every elementwise pass reads and
  writes its whole tensor, where XLA fuses such chains and charges their
  ends only.  So it is an upper count of what the step's kernels move,
  larger than the reference's ``hbm_bytes`` for the same step, and is not
  held to it.  The must-move floor stays
  :meth:`~repro_torch.models.model_zoo.ModelSizing.model_bytes` (the
  active weights once, plus the cache for a decode step).
* ``peak_bytes`` — the most bytes alive at once: the arguments, plus every
  fresh op output from its creation until its tensor is freed (autograd's
  saved tensors are held until the backward frees them).  An estimate: it
  follows the plain versions (the attention oracle materializes its score
  tensor, the kernels do not) and the allocator's caching is not modelled.

``transfers`` is filled only from a card's profiler records (the memcpy
records of a traced window, :func:`transfers_from_trace`), never estimated:
a meta run moves nothing.  ``collectives`` is empty on one card (the mesh
is ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Any, Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.sharding import tree_leaves, tree_map

__all__ = [
    "TransferStat",
    "CollectiveStat",
    "StepCost",
    "analyze_step",
    "transfers_from_trace",
]

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransferStat:
    """One copy record of the card's trace: the raw data-movement fact
    the transfer audit holds against the placement's allowance."""

    opcode: str               # the record's name, e.g. "Memcpy HtoD (Pinned -> Device)"
    name: str                 # its direction, "HtoD" | "DtoH" | "DtoD" | "HtoH"
    nbytes: float             # bytes moved
    src_space: str            # "host" | "device"
    dst_space: str
    count: float = 1.0
    op_name: str = ""

    @property
    def crosses_host(self) -> bool:
        """True when exactly one end is host memory: the host<->device
        traffic the paper's Fig. 17 datapath budgets per token."""
        return (self.src_space == "host") != (self.dst_space == "host")


@dataclasses.dataclass
class CollectiveStat:
    """A collective's payload and wire bytes (none on one card)."""

    opcode: str
    payload_bytes: float
    wire_bytes: float
    group_size: int
    axes: tuple[str, ...]
    count: float
    name: str = ""
    op_name: str = ""


@dataclasses.dataclass
class StepCost:
    """The counted work of one step (the reference's ``HloCost``)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list[CollectiveStat] = dataclasses.field(default_factory=list)
    #: the card's copy records of the step, when a profiler window read them
    transfers: list[TransferStat] = dataclasses.field(default_factory=list)
    instruction_count: float = 0.0
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    #: bytes by aten op name: where the bytes come from
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    #: bytes of the step's tensor arguments and of its tensor outputs
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    #: bytes of the outputs that are arguments handed back (updated in place)
    alias_bytes: float = 0.0
    #: the most bytes alive at once during the step (an estimate)
    peak_bytes: float = 0.0

    @property
    def collective_wire_bytes(self) -> float:
        return sum(c.wire_bytes for c in self.collectives)

    def wire_bytes_by_axis_group(self) -> dict[tuple[str, ...], float]:
        out: dict[tuple[str, ...], float] = defaultdict(float)
        for c in self.collectives:
            out[c.axes] += c.wire_bytes
        return dict(out)

    def wire_bytes_over(self, axis: str) -> float:
        return sum(c.wire_bytes for c in self.collectives if axis in c.axes)

    @property
    def host_transfer_bytes(self) -> float:
        """Total bytes crossing the host<->device boundary."""
        return sum(t.nbytes for t in self.transfers if t.crosses_host)

    def to_json(self) -> dict[str, Any]:
        return {
            "flops": self.flops, "dot_flops": self.dot_flops,
            "conv_flops": self.conv_flops, "hbm_bytes": self.hbm_bytes,
            "instruction_count": self.instruction_count,
            "argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
            "alias_bytes": self.alias_bytes, "peak_bytes": self.peak_bytes,
            "host_transfer_bytes": self.host_transfer_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "bytes_by_op": dict(sorted(self.bytes_by_op.items(),
                                       key=lambda kv: -kv[1])),
        }


# ---------------------------------------------------------------------------
# FLOPs of the products
# ---------------------------------------------------------------------------

def _mm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv(x, w, transposed: bool, out) -> float:
    """torch.utils.flop_counter's ``conv_flop_count``: 2 · output
    elements · input channels per group · kernel taps; a transposed
    convolution counts as the forward of its input."""
    taps = math.prod(w.shape[2:])
    if transposed:
        return 2.0 * x.numel() * w.shape[1] * taps
    return 2.0 * out.numel() * w.shape[1] * taps


def _product_flops(func, args, out) -> tuple[float, str]:
    """(FLOPs, "dot" | "conv" | "") of one aten op."""
    packet = func.overloadpacket
    if packet is aten.mm:
        return _mm(args[0], args[1]), "dot"
    if packet is aten.addmm:
        return _mm(args[1], args[2]), "dot"
    if packet is aten.bmm:
        return _bmm(args[0], args[1]), "dot"
    if packet is aten.baddbmm:
        return _bmm(args[1], args[2]), "dot"
    if packet in (aten.convolution, aten._convolution):
        return _conv(args[0], args[1], bool(args[6]), out), "conv"
    return 0.0, ""


# ---------------------------------------------------------------------------
# Bytes
# ---------------------------------------------------------------------------

#: ops that allocate or relabel without moving data
_NO_BYTES = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.detach, aten.alias,
    aten.lift_fresh, aten.lift_fresh_copy, aten._local_scalar_dense,
    aten.set_, aten.resize_,
}
#: in-place updates that write only their update: the packet's update arg
_UPDATE_ARG = {
    aten.index_put_: 2, aten._index_put_impl_: 2,
    aten.index_copy_: 3, aten.index_add_: 3, aten.scatter_: 3,
    aten.scatter_add_: 3, aten.scatter_reduce_: 3, aten.index_fill_: 2,
    aten.masked_scatter_: 2,
}
#: in-place ops that do not read their destination
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_, aten.uniform_}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _schema_flags(func):
    """(is a view, indices of the arguments the op writes)."""
    schema = func._schema
    rets = schema.returns
    view = bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)
    written = [i for i, a in enumerate(schema.arguments)
               if a.alias_info is not None and a.alias_info.is_write]
    return view, written


class _Counter(TorchDispatchMode):
    """Counts each op that reaches the dispatcher into a :class:`StepCost`."""

    def __init__(self, cost: StepCost, live: float):
        super().__init__()
        self.cost = cost
        self.live = live
        self._flags: dict = {}

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = self.cost
        cost.instruction_count += 1
        flops, kind = _product_flops(func, args, out)
        if kind:
            cost.flops += flops
            if kind == "dot":
                cost.dot_flops += flops
            else:
                cost.conv_flops += flops
        packet = func.overloadpacket
        if packet in _NO_BYTES:
            return out
        if func not in self._flags:
            self._flags[func] = _schema_flags(func)
        view, written = self._flags[func]
        if view:
            return out
        named = list(args) + [kwargs[a.name] for a in func._schema.arguments[len(args):]
                              if a.name in kwargs]
        if written:
            dst = [t for i in written if i < len(named) for t in _tensors(named[i])]
            rest = [t for i, a in enumerate(named) if i not in written
                    for t in _tensors(a)]
            if packet in _UPDATE_ARG:
                upd = _tensors(named[_UPDATE_ARG[packet]])
                nbytes = sum(map(_nbytes, rest)) + sum(map(_nbytes, upd))
            else:
                nbytes = sum(map(_nbytes, rest)) + sum(map(_nbytes, dst))
                if packet not in _WRITE_ONLY:
                    nbytes += sum(map(_nbytes, dst))
        else:
            fresh = _tensors(out)
            nbytes = sum(_nbytes(t) for a in named for t in _tensors(a))
            nbytes += sum(map(_nbytes, fresh))
            for t in fresh:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            cost.peak_bytes = max(cost.peak_bytes, self.live)
        cost.hbm_bytes += nbytes
        key = packet.__name__
        cost.bytes_by_op[key] = cost.bytes_by_op.get(key, 0.0) + nbytes
        return out


def _to_meta(tree):
    """``tree`` with every tensor leaf replaced by a ``meta`` tensor of its
    shape and dtype (``requires_grad`` kept); other leaves as they are."""
    def one(x):
        if isinstance(x, torch.Tensor):
            m = torch.empty(x.shape, dtype=x.dtype, device="meta")
            return m.requires_grad_(x.requires_grad)
        return x
    return tree_map(one, tree)


def _unique_bytes(tensors: Iterable[torch.Tensor]) -> float:
    seen, total = set(), 0.0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def analyze_step(fn: Callable, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once on ``meta`` tensors and count it.

    Tensor leaves of ``args`` / ``kwargs`` (nested dicts, lists, tuples)
    that are not on ``meta`` yet are replaced by meta tensors of their
    shape and dtype; nothing is computed and nothing is allocated.  A
    data-dependent step (an ``.item()``, ``nonzero``) fails on ``meta``.
    """
    args, kwargs = _to_meta(args), _to_meta(kwargs)
    arg_leaves = [t for t in tree_leaves([args, kwargs]) if isinstance(t, torch.Tensor)]
    cost = StepCost(argument_bytes=_unique_bytes(arg_leaves))
    cost.peak_bytes = cost.argument_bytes
    counter = _Counter(cost, cost.argument_bytes)
    # autograd's saved tensors stay alive (and counted) until the backward
    # drops them
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t), counter:
        out = fn(*args, **kwargs)
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    cost.output_bytes = _unique_bytes(outs)
    args_in = {id(t) for t in arg_leaves}
    cost.alias_bytes = _unique_bytes(t for t in outs if id(t) in args_in)
    return cost


# ---------------------------------------------------------------------------
# Copy records of a card's trace
# ---------------------------------------------------------------------------

_DIRECTIONS = {"HtoD": ("host", "device"), "DtoH": ("device", "host"),
               "DtoD": ("device", "device"), "HtoH": ("host", "host")}


def transfers_from_trace(events: Iterable[dict]) -> list[TransferStat]:
    """The copy records of a chrome trace (``torch.profiler``'s
    ``gpu_memcpy`` events, as a traced window returns them), each with its
    bytes and direction.  A peer-to-peer record counts as device to
    device."""
    out = []
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        name = e.get("name", "")
        direction = next((d for d in _DIRECTIONS if d in name), "DtoD")
        src, dst = _DIRECTIONS[direction]
        out.append(TransferStat(opcode=name, name=direction,
                                nbytes=float(e.get("args", {}).get("bytes", 0)),
                                src_space=src, dst_space=dst))
    return out
