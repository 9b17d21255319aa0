"""The attention, SSD and GEMM ops, dispatched on the tensors' device.

Counterpart of ``repro/kernels/ops.py`` (``attention``,
``decode_attention``, ``prefill_attention``, ``ssd_scan``,
``ssd_decode_step`` and ``matmul``), plus the memory microbenchmark ops
(``stream_read``, ``stream_fill``, ``chase``), which take the device that
reads: the card reads pinned host memory in place.  There is no ``backend``
knob: a CPU tensor takes the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, a CUDA tensor takes the hand-written CUDA
kernel, and anything else raises.  There is no fallback from the kernel
to the plain version.  A ``meta`` tensor (the dry run's, which
:mod:`repro_torch.core.op_analysis` counts) takes the plain version too:
it computes nothing, so this hides no device, and a CUDA tensor still
never takes the plain version.

Gradients: on the CPU autograd differentiates the plain version, as the
reference's ``jax.vjp`` differentiates its oracle.  On the card
:func:`attention` and :func:`ssd_scan` each run a
:class:`torch.autograd.Function` whose forward and backward are both CUDA
kernels.  The scan's Function runs on the CPU too, with the plain forward
and the plain backward (:func:`ref.ssd_scan_bwd`), so its bookkeeping is
tested there.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import membench, ref
from repro_torch.kernels.blocked_matmul import (
    DEFAULT_BK,
    DEFAULT_BM,
    DEFAULT_BN,
    blocked_matmul,
)
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import (
    fa_head_dims,
    flash_attention,
    flash_attention_bwd,
    flash_prefill,
)
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_scan_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as ssd_scan_bwd_kernel


def _route(t: torch.Tensor) -> str:
    """``"cuda"`` for the kernels, ``"cpu"`` or ``"meta"`` for the plain
    version; any other device raises."""
    if t.device.type in ("cpu", "cuda", "meta"):
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


class _SSDScan(torch.autograd.Function):
    """The scan with its backward: on the card the forward and backward
    kernels, on the CPU the plain versions.  The forward saves its inputs;
    the backward recomputes the chunk states from them (under
    ``checkpoint`` the forward kernel runs again first).  The gradient of
    the returned final state, when it is used, seeds the backward at the
    last position; the gradient of ``init_state`` is what reaches position
    0."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, init_state, return_state, chunk):
        if _route(x) == "cuda":
            out = ssd_scan_kernel(x, dt, A, Bmat, Cmat, init_state=init_state,
                                  return_state=return_state)
        else:
            out = ref.ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk,
                               init_state=init_state, return_state=return_state)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, init_state)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dy, d_state=None):
        x, dt, A, Bmat, Cmat, init_state = ctx.saved_tensors
        bwd = ssd_scan_bwd_kernel if _route(x) == "cuda" else ref.ssd_scan_bwd
        grads = bwd(x, dt, A, Bmat, Cmat, dy, chunk=ctx.chunk,
                    init_state=init_state, d_state_out=d_state)
        return (*grads, None, None)


def attention(
    q, k, v, *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
    k_lengths=None,
):
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) -> (B, Hq, Sq, Dv) GQA attention
    with mask kinds; ``v`` is (B, Hkv, Sk, Dv).

    A CUDA tensor takes the flash-attention kernels (``k_lengths`` is a
    decode-only argument they do not take: it raises there).  Head dims
    they do not take natively run zero-padded to the next pair they do
    (:func:`~repro_torch.kernels.flash_attention.fa_head_dims`: q and k to
    its q/k width, v to its v width), at the scale of the unpadded ``D``,
    the output sliced back (autograd drops the padded gradients); a pair
    with no wider kernel raises.  A CPU tensor takes the reference's
    dispatch: the chunked plain version from ``Sq >= 2048`` without
    ``k_lengths``, else the plain version.
    """
    if _route(q) == "cuda":
        if k_lengths is not None:
            raise ValueError("the flash-attention kernel takes no k_lengths")
        D, Dv = q.shape[-1], v.shape[-1]
        Dp, Dvp = fa_head_dims(q.dtype, D, Dv)
        if (Dp, Dvp) != (D, Dv):
            scale = D ** -0.5 if scale is None else scale
            q = torch.nn.functional.pad(q, (0, Dp - D))
            k = torch.nn.functional.pad(k, (0, Dp - D))
            v = torch.nn.functional.pad(v, (0, Dvp - Dv))
        out = _FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(),
            kind, window, chunk, scale, q_offset,
        )
        return out[..., :Dv] if Dvp != Dv else out
    if k_lengths is None and q.shape[2] >= 2048:
        return ref.attention_chunked(
            q, k, v, kind=kind, window=window, chunk=chunk,
            scale=scale, q_offset=q_offset,
        )
    return ref.attention(
        q, k, v, kind=kind, window=window, chunk=chunk,
        scale=scale, q_offset=q_offset, k_lengths=k_lengths,
    )


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None, kv_head=None):
    """(B, Hq, D) single-token decode against a padded KV cache; with
    ``kv_head`` every query head attends that one head of the cache (read
    in place by the kernel, a slice in the plain version)."""
    if _route(q) == "cuda":
        return flash_decode(q, k_cache, v_cache, lengths, scale=scale, kv_head=kv_head)
    return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                kv_head=kv_head)


def prefill_attention(
    q, k, v, q_pos, k_pos, *,
    k_new=None, v_new=None,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    kv_head: int | None = None,
):
    """(B, Hq, Sq, D) chunk queries vs the keys ``k ++ k_new``.

    With ``k_new``/``v_new`` absent this is the reference's one-source
    signature, ``k``/``v`` already holding cache ++ chunk.  The model
    passes the prior cache as ``k``/``v`` and the chunk's own keys as
    ``k_new``/``v_new``; ``k_pos`` covers both, cache slots first.  With
    ``kv_head`` every query head attends that one head of both sources
    (read in place by the kernel, a slice in the plain version).
    """
    if _route(q) == "cuda":
        return flash_prefill(
            q, k, v, q_pos, k_pos, k_new=k_new, v_new=v_new,
            kind=kind, window=window, chunk=chunk, scale=scale, kv_head=kv_head,
        )
    if kv_head is not None:
        heads = slice(kv_head, kv_head + 1)
        k, v = k[:, heads], v[:, heads]
        if k_new is not None:
            k_new, v_new = k_new[:, heads], v_new[:, heads]
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
    cache is updated without a copy.  When an input requires grad the scan
    goes through :class:`_SSDScan`, whose backward on the card is
    ``csrc/ssd_scan_bwd.cu`` (``state_out`` is serving's and is refused
    there).
    """
    if state_out is not None and not return_state:
        raise ValueError("state_out needs return_state=True")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, Bmat, Cmat, init_state)
    ):
        if state_out is not None:
            raise ValueError("state_out is an in-place serving buffer: it takes "
                             "no gradient")
        return _SSDScan.apply(x, dt, A, Bmat, Cmat, init_state, return_state, chunk)
    if _route(x) == "cuda":
        return ssd_scan_kernel(
            x, dt, A, Bmat, Cmat, init_state=init_state,
            return_state=return_state, chunk=chunk, state_out=state_out,
        )
    out = ref.ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk,
                       init_state=init_state, return_state=return_state)
    if state_out is None:
        return out
    y, state = out
    state_out.copy_(state)
    return y, state_out


def ssd_decode_step(x, dt, A, Bvec, Cvec, state):
    """One SSM recurrence step, (y, new_state).  Plain PyTorch on every
    device: the reference has no Pallas kernel for it (ROADMAP B4c lists a
    decode-step kernel as later work)."""
    return ref.ssd_decode_step(x, dt, A, Bvec, Cvec, state)


def matmul(
    a, b, *,
    out_dtype=None,
    bm: int = DEFAULT_BM,
    bn: int = DEFAULT_BN,
    bk: int = DEFAULT_BK,
):
    """(M, K) x (K, N) product with f32 accumulation, cast to ``out_dtype``.

    A CUDA tensor takes ``csrc/blocked_matmul.cu`` at the tiling (bm, bn,
    bk), which must have an instantiation; a CPU tensor takes
    :func:`ref.matmul`, which ignores the tiling, as the reference's
    ``"ref"`` backend does.
    """
    if _route(a) == "cuda":
        return blocked_matmul(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    return ref.matmul(a, b, out_dtype=out_dtype)


def _reader(x, device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu" and x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{dev} cannot read a tensor on {x.device}")


def stream_read(x, *, device):
    """Sum of float32 ``x`` read once by ``device``: on ``cuda`` the read
    kernel (``x`` in device memory or pinned host memory, read in place),
    on ``cpu`` :func:`ref.stream_read`.  A float64 scalar."""
    if _reader(x, device) == "cuda":
        return membench.stream_read(x)
    return ref.stream_read(x)


def stream_fill(x, value: float, *, device):
    """Every element of float32 ``x`` set to ``value`` by ``device``."""
    if _reader(x, device) == "cuda":
        return membench.stream_fill(x, value)
    return ref.stream_fill(x, value)


def chase(perm, steps: int, pos, *, device):
    """Dependent-load chain ``idx = perm[idx]`` walked by ``device`` from
    the index in ``pos`` and written back there: one thread of the card,
    or on ``cpu`` :func:`ref.chase`."""
    if _reader(perm, device) == "cuda":
        return membench.chase(perm, steps, pos)
    return ref.chase(perm, steps, pos)
