"""The attention and SSD ops the model calls, dispatched on the tensors' device.

Counterpart of ``repro/kernels/ops.py`` (``attention``,
``decode_attention``, ``prefill_attention``, ``ssd_scan`` and
``ssd_decode_step``).  There is no ``backend``
knob: a CPU tensor takes the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, a CUDA tensor takes the hand-written CUDA
kernel, and anything else raises.  There is no fallback from the kernel
to the plain version.

Gradients: on the CPU autograd differentiates the plain version, as the
reference's ``jax.vjp`` differentiates its oracle.  On the card
:func:`attention` is a :class:`torch.autograd.Function` whose forward and
backward are both CUDA kernels.  :func:`ssd_scan` has no backward
kernel yet: a CUDA input that requires grad raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_prefill,
)
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_scan_kernel


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no attention path for device {t.device}")


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward saves (q, k, v, out, lse); the backward launches the
    CUDA backward.  Under ``checkpoint`` the saved tensors are those of the
    recompute, whose forward launches the kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, chunk, scale, q_offset):
        mask = dict(kind=kind, window=window, chunk=chunk, scale=scale,
                    q_offset=q_offset)
        out, lse = flash_attention(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), **ctx.mask
        )
        return dq, dk, dv, None, None, None, None, None


def attention(
    q, k, v, *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
    k_lengths=None,
):
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) GQA attention with mask kinds.

    A CUDA tensor takes the flash-attention kernels (``k_lengths`` is a
    decode-only argument they do not take: it raises there).  A CPU tensor
    takes the reference's dispatch: the chunked plain version from
    ``Sq >= 2048`` without ``k_lengths``, else the plain version.
    """
    if _route(q) == "cuda":
        if k_lengths is not None:
            raise ValueError("the flash-attention kernel takes no k_lengths")
        return _FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(),
            kind, window, chunk, scale, q_offset,
        )
    if k_lengths is None and q.shape[2] >= 2048:
        return ref.attention_chunked(
            q, k, v, kind=kind, window=window, chunk=chunk,
            scale=scale, q_offset=q_offset,
        )
    return ref.attention(
        q, k, v, kind=kind, window=window, chunk=chunk,
        scale=scale, q_offset=q_offset, k_lengths=k_lengths,
    )


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None):
    """(B, Hq, D) single-token decode against a padded KV cache."""
    if _route(q) == "cuda":
        return flash_decode(q, k_cache, v_cache, lengths, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def prefill_attention(
    q, k, v, q_pos, k_pos, *,
    k_new=None, v_new=None,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
):
    """(B, Hq, Sq, D) chunk queries vs the keys ``k ++ k_new``.

    With ``k_new``/``v_new`` absent this is the reference's one-source
    signature, ``k``/``v`` already holding cache ++ chunk.  The model
    passes the prior cache as ``k``/``v`` and the chunk's own keys as
    ``k_new``/``v_new``; ``k_pos`` covers both, cache slots first.
    """
    if _route(q) == "cuda":
        return flash_prefill(
            q, k, v, q_pos, k_pos, k_new=k_new, v_new=v_new,
            kind=kind, window=window, chunk=chunk, scale=scale,
        )
    if k_new is not None:
        k = torch.cat([k, k_new], dim=2)
        v = torch.cat([v, v_new], dim=2)
    return ref.prefill_attention(
        q, k, v, q_pos, k_pos,
        kind=kind, window=window, chunk=chunk, scale=scale,
    )


def ssd_scan(
    x, dt, A, Bmat, Cmat, *,
    chunk: int = 64,
    init_state=None,
    return_state: bool = False,
    state_out=None,
):
    """(B, T, H, P) Mamba-2 chunked SSD scan, optionally carrying the state.

    A CUDA tensor takes ``csrc/ssd_scan.cu`` with or without a state (the
    reference runs its Pallas kernel only without one); a CPU tensor takes
    :func:`ref.ssd_scan`.  ``state_out`` (with ``return_state``) receives
    the final state in place and may be ``init_state`` itself: the serving
    cache is updated without a copy.  The kernel has no backward yet, so a
    CUDA input that requires grad raises.
    """
    if _route(x) == "cuda":
        if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bmat, Cmat, init_state)
        ):
            raise NotImplementedError(
                "ssd_scan has no backward kernel yet: training through "
                "Mamba-2 layers on the card is the SSM-training slice "
                "(ROADMAP A5)"
            )
        return ssd_scan_kernel(
            x, dt, A, Bmat, Cmat, init_state=init_state,
            return_state=return_state, chunk=chunk, state_out=state_out,
        )
    if state_out is not None and not return_state:
        raise ValueError("state_out needs return_state=True")
    out = ref.ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk,
                       init_state=init_state, return_state=return_state)
    if state_out is None:
        return out
    y, state = out
    state_out.copy_(state)
    return y, state_out


def ssd_decode_step(x, dt, A, Bvec, Cvec, state):
    """One SSM recurrence step, (y, new_state).  Plain PyTorch on every
    device: the reference has no Pallas kernel for it (ROADMAP B4 lists a
    decode-step kernel as later work)."""
    return ref.ssd_decode_step(x, dt, A, Bvec, Cvec, state)
