"""Memory microbenchmark kernels: streaming read, streaming fill, chase.

The CUDA kernels of ``repro_torch/csrc/membench.cu`` (its header says what
bounds them), built with ``nvcc`` on first use.  They are no port of a
Pallas kernel: the reference times XLA loops for these.  Each takes a
pointer the card reads either in device memory or in pinned host memory
in place; the C side checks which with ``cudaPointerGetAttributes`` and
returns an error for pageable host memory, on which these wrappers raise.
The plain versions are :func:`repro_torch.kernels.ref.stream_read`,
``stream_fill`` and ``chase``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: f64 scratch slots of the read kernel's block sums (csrc/membench.cu);
#: each call's scratch holds them, its result and its blocks' counter
MAX_BLOCKS = 4096

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.load("membench")
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        read = lib.membench_read_launch
        read.argtypes = [P, L, P, P, P, P]
        fill = lib.membench_fill_launch
        fill.argtypes = [P, L, ctypes.c_float, P]
        chase_fn = lib.membench_chase_launch
        chase_fn.argtypes = [P, I, P, P]
        for fn in (read, fill, chase_fn):
            fn.restype = I
        _fns = read, fill, chase_fn
    return _fns


def _card_of(x: torch.Tensor) -> torch.device:
    """The card that reads ``x``: its own for a CUDA tensor, the current
    one for host memory (which the C side checks is pinned)."""
    if x.device.type == "cuda":
        return x.device
    if x.device.type == "cpu":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"no card can read a tensor on {x.device}")


def _check(x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"need a contiguous, 16-byte aligned {dtype} tensor, "
                         f"got {x.dtype} (contiguous: {x.is_contiguous()})")


def stream_read(x: torch.Tensor) -> torch.Tensor:
    """Sum of float32 ``x`` (device or pinned host memory), read once by
    the card: a float64 scalar on the card."""
    _check(x, torch.float32)
    card = _card_of(x)
    scratch = torch.empty(MAX_BLOCKS + 2, dtype=torch.float64, device=card)
    with torch.cuda.device(card):
        status = _launchers()[0](
            x.data_ptr(), x.numel(), scratch.data_ptr(),
            scratch[MAX_BLOCKS].data_ptr(), scratch[MAX_BLOCKS + 1].data_ptr(),
            torch.cuda.current_stream(card).cuda_stream,
        )
    _build.check(status, "membench")
    stream_read.launches += 1
    return scratch[MAX_BLOCKS]


def stream_fill(x: torch.Tensor, value: float) -> torch.Tensor:
    """Write ``value`` to every element of float32 ``x`` (device or pinned
    host memory) from the card; returns ``x``."""
    _check(x, torch.float32)
    card = _card_of(x)
    with torch.cuda.device(card):
        status = _launchers()[1](
            x.data_ptr(), x.numel(), float(value),
            torch.cuda.current_stream(card).cuda_stream,
        )
    _build.check(status, "membench")
    stream_fill.launches += 1
    return x


def chase(perm: torch.Tensor, steps: int, pos: torch.Tensor) -> torch.Tensor:
    """Follow ``idx = perm[idx]`` ``steps`` times with one thread of the
    card, from the index in ``pos`` (a one-element int32 tensor on the
    card), and write the last index back to ``pos``, which is returned:
    the next call goes on where this one stopped.  ``perm`` is int32 in
    device or pinned host memory; every entry, and ``pos``, must lie in
    ``[0, perm.numel())`` (the card reads them, so nothing here checks)."""
    _check(perm, torch.int32)
    card = _card_of(perm)
    if (pos.device != card or pos.dtype != torch.int32 or pos.numel() != 1
            or steps < 0):
        raise ValueError(f"pos must be one int32 on {card} and steps >= 0, got "
                         f"{pos.dtype} x {pos.numel()} on {pos.device}, {steps}")
    with torch.cuda.device(card):
        status = _launchers()[2](
            perm.data_ptr(), steps, pos.data_ptr(),
            torch.cuda.current_stream(card).cuda_stream,
        )
    _build.check(status, "membench")
    chase.launches += 1
    return pos


#: launches of each kernel since the last reset
stream_read.launches = 0
stream_fill.launches = 0
chase.launches = 0
