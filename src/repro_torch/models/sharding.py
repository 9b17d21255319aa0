"""Parameter definitions and their materialization as tensors.

Counterpart of the ``Param`` / ``materialize`` / ``stack_defs`` half of
``repro/models/sharding.py``.  The port runs on one device, so there is no
mesh and no logical-axis rule table: the axes stay on each ``Param`` only
so that the defs read like the reference's.  Pytrees are plain nested
dicts and lists, the same shapes as the reference's, so carrying weights
across is a tree map (:mod:`repro_torch.convert`).
"""

from __future__ import annotations

import dataclasses

import torch

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
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
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
