"""Logical-axis sharding, parameter definitions and their materialization.

Counterpart of ``repro/models/sharding.py``.  Tensors are annotated with
*logical* axis names ("batch", "heads", "d_ff", "vocab", ...) and a
swappable rule table (:data:`DEFAULT_RULES`, overlaid by ``rules``) maps
those to mesh axes (:func:`spec_for`).  A rule is dropped for a tensor
dimension it does not divide (kv_heads = 2 over a 4-way ``model`` axis:
the kv heads are replicated) and for axes absent from the mesh.  Specs
are the port's own :class:`PartitionSpec`, a plain tuple; a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` or, where only the axis
sizes matter (the specs), any ``{axis: size}`` mapping.

The reference realizes a spec by handing it to XLA, whose SPMD
partitioner inserts the collectives.  The port realizes it by hand:
:func:`local_shape`, :func:`shard_of` (a rank's slice of a full tensor),
:func:`gather_full`, and the packed collectives the training step and the
ZeRO-3 window source use (:func:`all_gather_leaves`,
:func:`reduce_scatter_leaves`).  So the reference's ``shard(x, *axes)``
and ``shard_defs`` (``with_sharding_constraint``) have no counterpart as
constraints: at each of their call sites the port places the explicit
collective instead — Megatron's two operators over the ``model`` group
in ``models/layers.py`` and ``models/attention.py``, the ZeRO-3 window
gathers and gradient reduce-scatters in ``models/transformer.py``
(:class:`~repro_torch.models.transformer.GatheredWindows`), the data
reduction in ``train/train_step.py``.  ``donor_extend`` and
``_policy_specs`` compute specs over a donor axis; nothing realizes a
peer or remote tier yet (ROADMAP A10c).

Pytrees are plain nested dicts and lists, the same shapes as the
reference's, so carrying weights across is a tree map
(:mod:`repro_torch.convert`); a :class:`PartitionSpec` is a leaf.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import math
import threading
from typing import Mapping, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger("repro_torch.models.sharding")

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config string (``"bfloat16"``) or a dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return DTYPES[str(dtype)]


# ---------------------------------------------------------------------------
# Rules and specs
# ---------------------------------------------------------------------------

#: default rules — the reference's baseline: TP over the fast 'model'
#: axis, DP over 'data'+'pod', no FSDP, no sequence parallelism.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "d_ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": (),
    "lora": (),
    "ssm_heads": ("model",),
    "d_inner": ("model",),
    "state": (),
    "conv": (),
    "layers": (),
    "fsdp": (),       # extra param-dim sharding axis; () = ZeRO off
}


class PartitionSpec(tuple):
    """One entry per leading tensor dim: None (whole), a mesh axis name,
    or a tuple of names (split over their product, the first the major
    one).  Trailing whole dims are dropped, as the reference's are."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` with named dims or of a
    mapping; ``{}`` for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)
        self.one_rank = False


_CTX = _Ctx()


def _overlay(rules) -> dict[str, tuple[str, ...]]:
    return {**DEFAULT_RULES, **{
        k: tuple(v) if isinstance(v, (list, tuple)) else v
        for k, v in rules.items()
    }}


@contextlib.contextmanager
def use_sharding(mesh, rules: Mapping[str, Sequence[str]] | None = None, *,
                 one_rank: bool = False):
    """Install mesh + rules for the layers' model-axis collectives (the
    reference's trace-time constraint resolution).  ``one_rank``: the
    layers split over a ``model`` axis of one rank too (every collective
    runs, over one rank), to measure the collectives' cost on one card."""
    old = _CTX.mesh, _CTX.rules, _CTX.one_rank
    _CTX.mesh, _CTX.one_rank = mesh, one_rank
    if rules is not None:
        _CTX.rules = _overlay(rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.one_rank = old


def current_mesh():
    return _CTX.mesh


def one_rank_axes() -> bool:
    """Does the installed context split over one-rank axes too?"""
    return _CTX.one_rank


def current_rules() -> dict[str, tuple[str, ...]]:
    return _CTX.rules


#: per logical axis, the mesh axes the port's layers and reductions
#: realize a split over (the batch over the data axes, Megatron's four
#: over ``model``); the defaults' other splits over ``model`` (experts,
#: ssm_heads, d_inner) are the families
#: :meth:`~repro_torch.models.model_zoo.ModelBundle.check_model_axis`
#: refuses
REALIZED: dict[str, set[str]] = {
    "batch": {"pod", "data"}, "heads": {"model"}, "kv_heads": {"model"},
    "d_ff": {"model"}, "vocab": {"model"},
}


def unrealized_rules(rules, mesh) -> dict[str, tuple[str, ...]]:
    """The rules of the overlay ``rules`` that differ from
    :data:`DEFAULT_RULES` and split a logical axis over a mesh axis of
    several ranks that the port does not realize it on (:data:`REALIZED`):
    what a step on ``mesh`` must refuse."""
    wide = {a for a, n in mesh_shape(mesh).items() if n > 1}
    return {k: tuple(v) for k, v in _overlay(rules or {}).items() if k != "fsdp"
            and tuple(v) != DEFAULT_RULES.get(k) and set(v) & wide - REALIZED.get(k, set())}


def spec_for(
    shape: Sequence[int],
    axes: Sequence[str | None],
    mesh=None,
    rules: Mapping[str, Sequence[str]] | None = None,
) -> PartitionSpec:
    """PartitionSpec for ``shape`` under the rules, divisibility-checked.

    ``rules`` is an OVERLAY on DEFAULT_RULES — callers pass only the
    overrides (e.g. {"seq": ("model",)}) without losing the TP rules.
    """
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = _CTX.rules if rules is None else _overlay(rules)
    if mesh is None:
        return P()
    mesh_axes = mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, axes):
        assigned: list[str] = []
        if name:
            size = 1
            for m in rules.get(name, ()):
                if m not in mesh_axes or m in used:
                    continue
                if dim % (size * mesh_axes[m]) != 0:
                    continue
                assigned.append(m)
                size *= mesh_axes[m]
        used.update(assigned)
        out.append(tuple(assigned) if len(assigned) > 1
                   else (assigned[0] if assigned else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def fsdp_extend(
    spec: PartitionSpec,
    shape: Sequence[int],
    mesh,
    fsdp_axes: Sequence[str],
    logical_axes: Sequence[str | None] | None = None,
    prefer_stack: bool = False,
) -> PartitionSpec:
    """ZeRO-style extra sharding: place ``fsdp_axes`` on the first dim the
    base spec leaves unsharded and that they divide, so that per-rank
    residency of params and optimizer state scales with the data axis.

    The stacked ``layers`` dim is skipped when any other dim qualifies (a
    window of a layer stays a slice of every rank's shard);
    ``prefer_stack=True`` flips that preference (donor-axis streaming
    wants whole layers on the donor slices).
    """
    mesh_axes = mesh_shape(mesh)
    fsdp_axes = [a for a in fsdp_axes if a in mesh_axes]
    if not fsdp_axes:
        return spec
    size = math.prod(mesh_axes[a] for a in fsdp_axes)
    if any(a in spec_axes(spec) for a in fsdp_axes):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [
        i for i, dim in enumerate(shape)
        if entries[i] is None and dim % size == 0 and dim >= size
    ]
    layer = [
        i for i in candidates
        if logical_axes and i < len(logical_axes)
        and logical_axes[i] == "layers"
    ]
    non_layer = [i for i in candidates if i not in layer]
    ordered = layer + non_layer if prefer_stack else non_layer + layer
    if not ordered:
        return spec
    entries[ordered[0]] = tuple(fsdp_axes) if len(fsdp_axes) > 1 else fsdp_axes[0]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def donor_extend(
    spec: PartitionSpec,
    shape: Sequence[int],
    mesh,
    donor_axes: Sequence[str],
    logical_axes: Sequence[str | None] | None = None,
    prefer_stack: bool = False,
) -> PartitionSpec:
    """Extend ``spec`` over the donor axes (peer/remote realization): the
    mechanics of :func:`fsdp_extend`; ``prefer_stack=True`` targets the
    stacked ``layers`` dim first, so each streamed window is one layer."""
    return fsdp_extend(spec, shape, mesh, donor_axes, logical_axes, prefer_stack)


def spec_axes(spec: PartitionSpec) -> set[str]:
    """Every mesh-axis name a PartitionSpec references (tuples flattened)."""
    out: set[str] = set()
    for e in spec:
        out.update(e if isinstance(e, tuple) else [e])
    out.discard(None)
    return out


def defs_to_specs(
    defs,
    mesh,
    rules=None,
    fsdp_axes: Sequence[str] = (),
    donor_axes: Sequence[str] = (),
    donor_prefer_stack: bool = False,
):
    """Param-def pytree -> PartitionSpec pytree (the reference's
    NamedShardings without their memory kind, which the
    :class:`~repro_torch.api.Runtime` realizes per role).  ``donor_axes``
    is applied after ``fsdp_axes``, so the two compose onto different
    dims."""
    def one(p: Param):
        spec = spec_for(p.shape, p.axes, mesh, rules)
        if fsdp_axes:
            spec = fsdp_extend(spec, p.shape, mesh, fsdp_axes, p.axes)
        if donor_axes:
            spec = donor_extend(spec, p.shape, mesh, donor_axes, p.axes,
                                prefer_stack=donor_prefer_stack)
        return spec

    return tree_map(one, defs)


def _policy_specs(defs, mesh, rules, role, policy, fsdp_axes: Sequence[str] = ()):
    """The PartitionSpecs realizing ``policy``'s placement of ``role``:
    the rules, ``fsdp_axes`` and, for a peer/remote tier, the donor mesh
    axes that would hold the bytes.  Raises
    :class:`~repro_torch.core.placement.DonorAxisError` when the mesh
    cannot realize the tier.  Reached through
    :meth:`repro_torch.api.Runtime.specs`."""
    from repro_torch.core.placement import Strategy, donor_axes_for

    pl = policy.placement(role)
    donor = donor_axes_for(mesh_shape(mesh), pl.tier)
    specs = defs_to_specs(
        defs, mesh, rules, fsdp_axes=fsdp_axes, donor_axes=donor,
        donor_prefer_stack=pl.strategy is Strategy.STREAM,
    )
    if donor:
        local = sum(1 for s in tree_leaves(specs) if not spec_axes(s) & set(donor))
        if local:
            log.warning(
                "policy %s/%s: %d of %d tensors could not be donor-sharded over "
                "%s (no divisible free dim) and stay in local memory — donor-pool "
                "capacity accounting is optimistic for them",
                policy.name, role.value, local, len(tree_leaves(specs)), donor)
    return specs


# ---------------------------------------------------------------------------
# Realizing a spec over a DeviceMesh
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_dim(spec: PartitionSpec, axis: str) -> int | None:
    """The dim whose spec entry names ``axis``; None when none does."""
    for i, e in enumerate(spec):
        if axis in entry_axes(e):
            return i
    return None


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(e))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {e!r} ({n})")
        out[i] //= n
    return tuple(out)


def local_defs(defs, specs, mesh):
    """Param-def pytree -> the same defs at one rank's shard shapes
    (:func:`local_shape`), so a rank makes its shards directly (a cache at
    its local shape, never at full size followed by a slice)."""
    return tree_map(lambda p, sp: dataclasses.replace(p, shape=local_shape(p.shape, sp, mesh)),
                    defs, specs)


def batch_block(batch: int, mesh, rules=None) -> tuple[int, int]:
    """(index, count): this rank's block of a ``batch``-row tensor's
    rows under the logical ``"batch"`` axis's spec (with its divisibility
    drop: where the axes do not divide the rows, every rank holds every
    row and this is (0, 1)); (0, 1) without a mesh."""
    spec = spec_for((batch,), ("batch",), mesh, rules)
    index, count = 0, 1
    sizes = mesh_shape(mesh)
    for a in entry_axes(spec[0]) if spec else ():
        index, count = index * sizes[a] + mesh.get_local_rank(a), count * sizes[a]
    return index, count


def slot_owner(slot: int, batch: int, count: int) -> tuple[int, int]:
    """(block, local index) of global row ``slot`` of ``batch`` rows cut
    into ``count`` blocks (:func:`batch_block`): the rank whose block index
    is ``block`` holds it, at ``local index`` of its rows."""
    return divmod(slot, batch // count)


def shard_of(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` under ``spec`` (a view):
    along a dim split over axes (a1, a2, ...) the shard index is the
    row-major index of the rank's coordinates on them."""
    sizes = mesh_shape(mesh)
    for i, e in enumerate(spec):
        idx = 0
        for a in entry_axes(e):
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        n = math.prod(sizes[a] for a in entry_axes(e))
        if n > 1:
            part = x.shape[i] // n
            x = x.narrow(i, idx * part, part)
    return x


#: the collectives :func:`gather_dim` and the layers' Megatron operators
#: issued, by kind, since the process started: a CUDA graph's capture
#: counts what one replay runs (``Executor.graph_collectives``)
COLLECTIVES: collections.Counter = collections.Counter()


def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim``, in
    rank order (one all-gather)."""
    buf = x.new_empty((n, *x.shape))
    dist.all_gather(list(buf.unbind(0)), x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    shape = list(x.shape)
    shape[dim] *= n
    return buf.movedim(0, dim).reshape(shape)


def gather_full(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The full tensor from each rank's shard ``x`` under ``spec``: an
    all-gather over every axis it names (the minor axis of a tuple entry
    first)."""
    sizes = mesh_shape(mesh)
    for i, e in enumerate(spec):
        for a in reversed(entry_axes(e)):
            if sizes[a] > 1:
                x = gather_dim(x, i, mesh.get_group(a), sizes[a])
    return x


#: byte alignment of each leaf in a packed buffer (any dtype views it)
_ALIGN = 16


def padded(nbytes: int) -> int:
    """``nbytes`` rounded up to the packing alignment."""
    return -(-nbytes // _ALIGN) * _ALIGN


#: the most bytes one packed collective carries: a longer list of leaves
#: goes in buckets of consecutive leaves, so the pack, its receive buffer
#: and (reducing) the f32 copy stay this size whatever the tree's
BUCKET_BYTES = 256 << 20


def _buckets(xs, idx: list[int], per_elem: int | None = None) -> list[list[int]]:
    """``idx`` cut into runs of consecutive leaves of at most
    :data:`BUCKET_BYTES` each (a larger leaf alone); ``per_elem``: the
    bytes an element counts (its own size by default)."""
    out, cur, size = [], [], 0
    for i in idx:
        nb = xs[i].numel() * (per_elem or xs[i].element_size())
        if cur and size + nb > BUCKET_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nb
    return out + ([cur] if cur else [])


def all_gather_leaves(xs: Sequence[torch.Tensor], dims: Sequence[int | None], mesh,
                      axis: str, outs: Sequence[torch.Tensor] | None = None) -> list:
    """Each ``xs[i]`` gathered over ``axis`` along ``dims[i]`` (None: kept
    as it is) by one all-gather of the leaves' packed bytes a bucket
    (:data:`BUCKET_BYTES`).  ``outs``: tensors of the gathered shapes to
    write into (a window source's slot views); else new tensors."""
    n, group = mesh_shape(mesh)[axis], mesh.get_group(axis)
    res = list(xs)
    for idx in _buckets(xs, [i for i, d in enumerate(dims) if d is not None]):
        sizes = [xs[i].numel() * xs[i].element_size() for i in idx]
        flat = torch.zeros(sum(padded(b) for b in sizes), dtype=torch.uint8,
                           device=xs[idx[0]].device)
        off = 0
        for i, nb in zip(idx, sizes):
            flat[off:off + nb].copy_(xs[i].contiguous().reshape(-1).view(torch.uint8))
            off += padded(nb)
        buf = flat.new_empty((n, flat.numel()))
        dist.all_gather(list(buf.unbind(0)), flat, group=group)
        off = 0
        for i, nb in zip(idx, sizes):
            x, d = xs[i], dims[i]
            part = buf[:, off:off + nb].view(x.dtype).view(n, *x.shape).movedim(0, d)
            if outs is not None:
                outs[i].view(*x.shape[:d], n, *x.shape[d:]).copy_(part)
                res[i] = outs[i]
            else:
                res[i] = part.reshape(*x.shape[:d], n * x.shape[d], *x.shape[d + 1:])
            off += padded(nb)
    return res


def reduce_scatter_leaves(xs: Sequence[torch.Tensor], dims: Sequence[int | None], mesh,
                          axis: str) -> list:
    """The f32 sums over ``axis`` of the ranks' ``xs``: a leaf with a dim
    comes back as this rank's shard of its sum along that dim (one
    reduce-scatter a bucket of them, :data:`BUCKET_BYTES` of f32), a
    leaf without one whole (one all-reduce a bucket of those)."""
    n, group = mesh_shape(mesh)[axis], mesh.get_group(axis)
    res: list = [None] * len(xs)
    for idx in _buckets(xs, [i for i, d in enumerate(dims) if d is not None], 4):
        rows = []
        for i in idx:
            x, d = xs[i].float(), dims[i]
            rows.append(x.reshape(*x.shape[:d], n, x.shape[d] // n, *x.shape[d + 1:])
                        .movedim(d, 0).reshape(n, -1))
        send = torch.cat(rows, dim=1)
        out = send.new_empty(send.shape[1])
        dist.reduce_scatter(out, list(send.unbind(0)), group=group)
        for i, part in zip(idx, out.split([r.shape[1] for r in rows])):
            shape = list(xs[i].shape)
            shape[dims[i]] //= n
            res[i] = part.view(shape)
    for idx in _buckets(xs, [i for i, d in enumerate(dims) if d is None], 4):
        flat = torch.cat([xs[i].float().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([xs[i].numel() for i in idx])):
            res[i] = part.view(xs[i].shape)
    return res


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Param:
    """Declarative parameter: shape + logical axes + init scale.

    Also used as the shaped placeholder for non-parameter state (caches);
    ``dtype=None`` means "the model dtype".
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # None -> 1/sqrt(shape[0])
    dtype: str | None = None      # None -> model default

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples.

    With further trees, ``fn`` gets the leaves found at the same path in
    each (dict entries by key, not by order).
    """
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


#: the largest float32 draw of one leaf: a leaf above it is drawn in
#: slices (a stacked MoE expert leaf of llama4 is 21.5 GB in float32)
DRAW_BYTES = 1 << 30


def _init_one(p: Param, generator: torch.Generator, dtype) -> torch.Tensor:
    """The reference's rule: integer leaves and ``zeros`` inits are zeros,
    ``ones`` are ones, and ``normal`` draws N(0, 1) in float32 times
    ``scale`` (default ``1/sqrt(shape[0])`` of the def as materialized, so
    a stacked def scales by its stack count) before the cast.  The draw
    is made slice by slice — runs of whole rows along the leaf's leading
    dims, at most :data:`DRAW_BYTES` of float32 each — and each slice is
    cast into the preallocated output, so no float32 copy of a large leaf
    exists; a leaf within :data:`DRAW_BYTES` is one slice, the same draw
    as one ``randn`` of its shape."""
    dt = torch_dtype(p.dtype or dtype)
    dev = generator.device
    if not dt.is_floating_point or p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=dev)
    scale = p.scale if p.scale is not None else max(p.shape[0], 1) ** -0.5
    out = torch.empty(p.shape, dtype=dt, device=dev)
    width = max(p.shape[-1], 1)
    rows = out.view(-1, width)
    step = max(1, DRAW_BYTES // (4 * width))
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=dev).mul_(scale))
    return out


def materialize(defs, generator: torch.Generator, dtype) -> dict:
    """Param-def pytree -> tensor pytree on ``generator``'s device."""
    return tree_map(lambda p: _init_one(p, generator, dtype), defs)


def zeros_like_defs(defs, dtype, device) -> dict:
    """Param-def pytree -> zero tensors (caches need no generator)."""
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch_dtype(p.dtype or dtype),
                              device=device),
        defs,
    )


def stack_defs(defs, count: int, axis_name: str | None = "layers"):
    """Stack a layer's param defs ``count`` times (the layer loop's axis).

    Preserves every per-def field — notably an explicit ``dtype``: losing
    it here would materialize a stacked leaf in the model dtype while the
    step function emits the pinned one.
    """
    return tree_map(
        lambda p: Param(
            (count, *p.shape), (axis_name, *p.axes), p.init, p.scale,
            p.dtype,
        ),
        defs,
    )
