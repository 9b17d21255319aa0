"""Single-token GQA decode attention: the CUDA kernel and its wrapper.

Counterpart of ``repro/kernels/decode_attention.py`` (``flash_decode``).
The kernel lives in ``repro_torch/csrc/decode_attention.cu`` (its header
says what bounds it and how it is laid out); it is built with ``nvcc`` on
first use.  The plain version of the same function is
:func:`repro_torch.kernels.ref.decode_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_D = (16, 32, 64, 128)
MAX_GROUP = 16          # largest Hq / Hkv the kernel's shared memory holds
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.load("decode_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        splits = lib.decode_attention_num_splits
        splits.argtypes = [I, I, I, I]
        splits.restype = I
        launch = lib.decode_attention_launch
        launch.argtypes = [P] * 7 + [I] * 7 + [ctypes.c_float, P]
        launch.restype = I
        _fns = splits, launch
    return _fns


def check_operands(tensors: dict, *, dtype, device) -> None:
    """Raise on anything the CUDA kernels do not take: device, dtype,
    contiguity, 16-byte alignment (the kernels load 16 bytes a thread)."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_decode(
    q: torch.Tensor,        # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hkv, Smax, D)
    v_cache: torch.Tensor,  # (B, Hkv, Smax, D)
    lengths: torch.Tensor,  # (B,) int32 valid entries per row
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the decode kernel on ``q``'s device and current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}: want (B,Hq,D), (B,Hkv,Smax,D) x2"
        )
    B, Hq, D = q.shape
    _, Hkv, Smax, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not in {SUPPORTED_D}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq}, Hkv={Hkv}: need Hkv | Hq and Hq/Hkv <= {MAX_GROUP}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be a (B,) int32 tensor")
    check_operands({"q": q, "k_cache": k_cache, "v_cache": v_cache},
                   dtype=q.dtype, device=q.device)
    check_operands({"lengths": lengths}, dtype=torch.int32, device=q.device)
    scale = D ** -0.5 if scale is None else float(scale)

    splits, launch = _launchers()
    code = DTYPE_CODES[q.dtype]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        # the live keys of each (row, KV head) are split over NS blocks;
        # their partial (acc, m, l) are combined by a second kernel
        ns = splits(B, Hkv, Smax, code)
        part_acc = torch.empty((B, Hkv, ns, Hq // Hkv, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, Hkv, ns, Hq // Hkv, 2), dtype=torch.float32,
                              device=q.device)
        status = launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), B, Hq, Hkv, Smax, D, ns, code, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "decode_attention")
    flash_decode.launches += 1
    return out


#: launches of the decode kernel since the last reset
flash_decode.launches = 0
