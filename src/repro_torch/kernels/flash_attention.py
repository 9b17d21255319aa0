"""Chunked-prefill GQA attention: the CUDA kernel and its wrapper.

Counterpart of ``repro/kernels/flash_attention.py`` — ``flash_prefill``
only; ``flash_attention`` (full-sequence training attention) is still to
be ported.  The kernel lives in ``repro_torch/csrc/prefill_attention.cu``
and is built with ``nvcc`` on first use.  Unlike the Pallas kernel it
reads keys from two sources — the prior cache and the chunk's own keys —
so the model no longer concatenates them.  The plain version of the same
function is :func:`repro_torch.kernels.ref.prefill_attention` over the
concatenation.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    DTYPE_CODES,
    SUPPORTED_D,
    check_operands,
)

MASK_KINDS = {"causal": 0, "sliding": 1, "chunked": 2}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("prefill_attention")
        fn = lib.prefill_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 11 + [ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def flash_prefill(
    q: torch.Tensor,        # (B, Hq, Sq, D) chunk queries
    k: torch.Tensor,        # (B, Hkv, Sc, D) prior cache (first key source)
    v: torch.Tensor,        # (B, Hkv, Sc, D)
    q_pos: torch.Tensor,    # (B, Sq) int32 absolute query positions
    k_pos: torch.Tensor,    # (B, Sc + Sn) int32 key positions; < 0 = hole
    *,
    k_new: torch.Tensor | None = None,   # (B, Hkv, Sn, D) chunk keys
    v_new: torch.Tensor | None = None,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the prefill kernel on ``q``'s device and current stream.

    Key index ``j < Sc`` is read from ``k``/``v`` and ``j >= Sc`` from
    ``k_new``/``v_new``; without a second source (``k_new=None``) this is
    the one-source function of the reference, with ``Sn = 0``.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_prefill takes float32 or bfloat16, got {q.dtype}")
    if kind not in MASK_KINDS:
        raise ValueError(f"prefill mask kind {kind!r}")
    if kind == "chunked" and chunk <= 0:
        raise ValueError("chunked mask needs chunk > 0")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    B, Hq, Sq, D = q.shape
    _, Hkv, Sc, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if k_new is None:
        k_new, v_new, Sn = k, v, 0
    else:
        Sn = k_new.shape[2]
        if k_new.shape != (B, Hkv, Sn, D) or v_new.shape != k_new.shape:
            raise ValueError(
                f"chunk keys {tuple(k_new.shape)} / values {tuple(v_new.shape)} "
                f"do not match (B, Hkv, Sn, D) = ({B}, {Hkv}, Sn, {D})"
            )
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not in {SUPPORTED_D}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sc + Sn):
        raise ValueError(
            f"q_pos {tuple(q_pos.shape)} / k_pos {tuple(k_pos.shape)}: want "
            f"({B}, {Sq}) / ({B}, {Sc + Sn})"
        )
    check_operands({"q": q, "k": k, "v": v, "k_new": k_new, "v_new": v_new},
                   dtype=q.dtype, device=q.device)
    check_operands({"q_pos": q_pos, "k_pos": k_pos},
                   dtype=torch.int32, device=q.device)
    scale = D ** -0.5 if scale is None else float(scale)

    fn = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Sc, Sn, D, DTYPE_CODES[q.dtype],
            MASK_KINDS[kind], int(window), int(chunk), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "prefill_attention")
    flash_prefill.launches += 1
    return out


#: launches of the prefill kernel since the last reset
flash_prefill.launches = 0
