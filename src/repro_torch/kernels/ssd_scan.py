"""Mamba-2 chunked SSD scan: the CUDA kernel and its wrapper.

Counterpart of ``repro/kernels/ssd_scan.py`` (``ssd_scan``).  The kernel
lives in ``repro_torch/csrc/ssd_scan.cu`` (its header says what bounds it
and how it is laid out); it is built with ``nvcc`` on first use.  Unlike
the Pallas kernel it takes an initial state and returns the final one, so
it carries serving prefill as well.  The plain version of the same
function is :func:`repro_torch.kernels.ref.ssd_scan`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_P = (32, 64)
SUPPORTED_N = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn = lib.ssd_scan_launch
        fn.argtypes = ([P, L, L, L, P, L, L, L, P, P, L, L, P, L, L, P, P, P]
                       + [I] * 6 + [P])
        fn.restype = I
        _fn = fn
    return _fn


def _check_state(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 tensor on {device}, got "
                        f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, got "
                         f"{tuple(t.shape)}")


def ssd_scan(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) float32
    A: torch.Tensor,      # (H,) float32
    Bmat: torch.Tensor,   # (B, T, N)
    Cmat: torch.Tensor,   # (B, T, N)
    *,
    init_state: torch.Tensor | None = None,   # (B, H, P, N) float32
    return_state: bool = False,
    chunk: int | None = None,
    state_out: torch.Tensor | None = None,
):
    """Launch the SSD kernel on ``x``'s device and current stream.

    Returns ``y`` (B, T, H, P) in x's dtype, and with ``return_state`` the
    final state (B, H, P, N) float32 as well.  ``state_out`` (with
    ``return_state``) is the buffer the final state is written to; it may
    be ``init_state`` itself — the kernel reads each (row, head) slice of
    the initial state whole before it writes that slice.

    ``chunk`` is accepted for the reference's signature and not used: the
    kernel walks its own chunks of 32 positions, and its result equals the
    chunked oracle's at any chunk up to f32 rounding.  T may be anything
    (no ``T % chunk`` requirement).  x, B and C may be strided views (the
    model passes slices of the conv output); their last dim must be
    contiguous.
    """
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, T, H, P), got {tuple(x.shape)}")
    Bsz, T, H, P = x.shape
    N = Bmat.shape[-1]
    if P not in SUPPORTED_P or N not in SUPPORTED_N:
        raise ValueError(f"head dim P={P} / state N={N} not in "
                         f"{SUPPORTED_P} / {SUPPORTED_N}")
    if tuple(dt.shape) != (Bsz, T, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    for name, t in (("Bmat", Bmat), ("Cmat", Cmat)):
        if tuple(t.shape) != (Bsz, T, N):
            raise ValueError(f"{name} must be {(Bsz, T, N)}, got {tuple(t.shape)}")
    for name, t, dtype in (("dt", dt, torch.float32), ("A", A, torch.float32),
                           ("Bmat", Bmat, x.dtype), ("Cmat", Cmat, x.dtype)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if x.stride(3) != 1 or Bmat.stride(2) != 1 or Cmat.stride(2) != 1:
        raise ValueError("the last dim of x, Bmat and Cmat must be contiguous")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if state_out is not None and not return_state:
        raise ValueError("state_out needs return_state=True")
    shape = (Bsz, H, P, N)
    if init_state is not None:
        _check_state("init_state", init_state, shape, x.device)
    if return_state:
        if state_out is None:
            state_out = torch.empty(shape, dtype=torch.float32, device=x.device)
        _check_state("state_out", state_out, shape, x.device)

    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _launcher()(
            x.data_ptr(), *x.stride()[:3],
            dt.data_ptr(), *dt.stride(),
            A.data_ptr(),
            Bmat.data_ptr(), *Bmat.stride()[:2],
            Cmat.data_ptr(), *Cmat.stride()[:2],
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            Bsz, T, H, P, N, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "ssd_scan")
    ssd_scan.launches += 1
    return (y, state_out) if return_state else y


#: launches of the SSD kernel since the last reset
ssd_scan.launches = 0
