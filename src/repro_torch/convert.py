"""Carry reference weights and caches across: numpy pytree -> tensor pytree.

The reference's params and caches are nested dicts/lists of arrays with
the same structure as the port's, so conversion is a tree map over
``np.asarray`` of each leaf.  bfloat16 leaves (numpy's ``bfloat16``
extension dtype) go through float32, which represents every bfloat16
value exactly, and are cast back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.sharding import torch_dtype, tree_map


def _leaf(a, device: torch.device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    kind = a.dtype.kind
    if kind in "iub":
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    target = torch_dtype(dtype) if dtype is not None else torch_dtype(a.dtype.name)
    f32 = np.array(a, dtype=np.float32, copy=True)
    return torch.from_numpy(f32).to(device=device, dtype=target)


def params_from_jax(tree, device=None, dtype=None) -> dict:
    """Tensor pytree from a numpy pytree of reference weights.

    ``dtype`` (a torch dtype or config string) casts every floating leaf;
    ``None`` keeps each leaf's own dtype.  Integer leaves keep theirs.
    """
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev, dtype), tree)


def caches_from_jax(tree, device=None, dtype=None, *, defs=None) -> dict:
    """Tensor pytree from a numpy pytree of reference caches.

    A cast needs the cache ``defs`` (``ModelBundle.cache_defs``, the same
    structure): a leaf whose def pins its dtype — the SSM recurrent state's
    float32 — keeps it, where a blanket cast to the model dtype would drop
    the pin.
    """
    if dtype is None:
        return params_from_jax(tree, device)
    if defs is None:
        raise ValueError(
            "caches_from_jax with a dtype needs the cache defs, so that "
            "float32-pinned leaves (the SSM state) stay float32"
        )
    dev = resolve_device(device)
    return tree_map(lambda a, p: _leaf(a, dev, p.dtype or dtype), tree, defs)
