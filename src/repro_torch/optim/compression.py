"""Int8 gradient compression with error feedback for the DCN (pod) axis.

Counterpart of ``repro/optim/compression.py``.  The paper's internode
measurements (Figs. 14, 19) show the NIC is the weakest datapath; in
training it carries one traffic class, the cross-pod gradient all-reduce.
This module quantizes that traffic to int8 (4x fewer wire bytes) with
error feedback, so the quantization error is re-injected next step.

Mechanics, as the reference's: the all-reduce over the ``pod`` group is
all-to-all (int8 segments) -> local f32 mean -> requantize -> all-gather
(int8), through ``torch.distributed`` collectives: every wire crossing is
int8, every accumulation is f32.  The arithmetic is plain PyTorch on
whatever device the tensors live on; the reference computes it in plain
``jnp`` too (no Pallas kernel).

:func:`compressed_grad_sync` takes each pod's own mean gradient and is the
only sync of it over ``pod`` (ROADMAP C4: the reference's jitted step
averages over ``pod`` in f32 before it, so its int8 wire re-syncs equal
values).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_size
from repro_torch.models.sharding import tree_leaves, tree_map


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q int8, scale f32 scalar),
    ``scale = max|x| / 127 + 1e-12``, rounded half to even."""
    xf = x.float()
    scale = xf.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _gather_scalar(s: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(s.reshape(1)) for _ in range(n)]
    dist.all_gather(parts, s.reshape(1), group=group)
    return torch.cat(parts)


def quantized_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` with int8 wire traffic.

    ``x`` is this rank's f32 tensor; every rank gets the same f32 result.
    A group of one rank (or ``None``) returns ``x`` itself.
    """
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return x
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    segs = F.pad(flat, (0, pad)).reshape(n, -1)       # segment s for rank s

    q, scale = quantize(segs)
    q_recv = torch.empty_like(q)
    dist.all_to_all_single(q_recv, q, group=group)    # (n, seg) int8 on the wire
    scales = _gather_scalar(scale, group, n)          # (n,) f32 (tiny)
    local = (q_recv.float() * scales[:, None]).sum(0) / n   # mean, f32

    q2, scale2 = quantize(local)
    parts = [torch.empty_like(q2) for _ in range(n)]
    dist.all_gather(parts, q2, group=group)           # (n, seg) int8 on the wire
    scale_all = _gather_scalar(scale2, group, n)
    out = (torch.stack(parts).float() * scale_all[:, None]).reshape(-1)
    return out[:flat.numel()].reshape(shape)


def init_error_feedback(grads):
    """One f32 zero tensor of each leaf's shape."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_grad_sync(grads, ef, mesh, axis: str = "pod"):
    """Cross-pod gradient mean with int8 wire traffic and error feedback.

    ``grads`` are this pod's mean gradients and ``ef`` the persistent
    error-feedback tree (:func:`init_error_feedback`).  Per leaf: ``gf =
    g + e`` in f32, ``synced`` its quantized mean over ``axis``, the new
    error ``gf - synced``, and ``synced`` cast back to ``g``'s dtype.
    Returns ``(synced_grads, new_ef)``; returns the inputs as they are
    when ``mesh`` is None, has no ``axis`` or has one rank on it.
    """
    if axis_size(mesh, axis) == 1:
        return grads, ef
    group = mesh.get_group(axis)
    out, new_ef = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef)):
        gf = g.float() + e
        synced = quantized_all_reduce(gf, group)
        out.append(synced.to(g.dtype))
        new_ef.append(gf - synced)               # residual re-injected later
    it_g, it_e = iter(out), iter(new_ef)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), ef))
