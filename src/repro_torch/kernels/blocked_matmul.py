"""Tiled GEMM: the CUDA kernel, its wrapper, and the tiling's traffic model.

Counterpart of ``repro/kernels/blocked_matmul.py`` (``blocked_matmul``,
``traffic_model``, ``best_tiling``): the paper's GEMM study (Figs. 15-16)
one tier down, where the tiling decides how often each operand byte
crosses the device-memory bus.  The kernel lives in
``repro_torch/csrc/blocked_matmul.cu`` (its header says what bounds it and
how it is laid out) and is built with ``nvcc`` on first use; the plain
version of the same function is :func:`repro_torch.kernels.ref.matmul`.

The TPU kernel kept its f32 accumulator in a VMEM scratch and sized its
tiles against ~96 MiB of VMEM.  Here the accumulator lives in registers
and the tiles in shared memory, of which one block may use 227 KB
(232,448 bytes).  The kernel has one fixed set of tilings (:data:`TILINGS`).
In bf16 it streams A and B tiles through a ring of up to 4 stages
(:func:`ring_stages`) filled by TMA and read by ``wgmma``; in f32 it stages
one A tile and one B tile per K step, rows padded by 16 bytes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: shared memory one block may use on an H100 (227 KB; NVIDIA's Hopper
#: tuning guide)
SMEM_BUDGET = 232_448

#: the (bm, bn, bk) tilings csrc/blocked_matmul.cu instantiates, for both
#: input dtypes; (256, 128, 256) fits only in bf16
TILINGS = (
    (128, 128, 32), (128, 128, 64), (128, 128, 128),
    (256, 128, 32), (256, 128, 64), (256, 128, 128), (256, 128, 256),
)

#: The default tiling: best_tiling's pick for large square products (the
#: widest tile, then the least shared memory).  The reference's 256 x 256 x
#: 512 would need 512 KB of bf16 A and B tiles, more than a block can hold.
DEFAULT_BM = 256
DEFAULT_BN = 128
DEFAULT_BK = 32

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("blocked_matmul")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.blocked_matmul_launch
        fn.argtypes = [P, P, P] + [I] * 8 + [P]
        fn.restype = I
        _fn = fn
    return _fn


#: most stages of the bf16 kernel's ring, and the shared memory it adds to
#: the stages: 1024 bytes to align the ring to the 128-byte swizzle's
#: period, and two 8-byte mbarriers a stage
RING_MAX_STAGES = 4
RING_ALIGN = 1024
RING_BARRIER_BYTES = 16


def ring_stages(bm: int, bn: int, bk: int) -> int:
    """Stages of the bf16 kernel's ring for a tiling: the most, at most 4,
    whose bf16 A and B tiles (and barriers) fit 227 KB; at least 1."""
    stage = (bm * bk + bk * bn) * 2 + RING_BARRIER_BYTES
    return max(1, min(RING_MAX_STAGES, (SMEM_BUDGET - RING_ALIGN) // stage))


def supported(bm: int, bn: int, bk: int, itemsize: int) -> bool:
    """Is there an instantiation of this tiling whose tiles fit a block?"""
    return ((bm, bn, bk) in TILINGS
            and traffic_model(bm, bn, bk, bm, bn, bk, itemsize)["smem_bytes"]
            <= SMEM_BUDGET)


def blocked_matmul(
    a: torch.Tensor,   # (M, K)
    b: torch.Tensor,   # (K, N)
    *,
    bm: int = DEFAULT_BM,
    bn: int = DEFAULT_BN,
    bk: int = DEFAULT_BK,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Launch the tiled GEMM on ``a``'s device and current stream.

    As in the reference, each tile edge is first clamped to its dimension
    (``bm = min(bm, M)``...) and ``M % bm``, ``N % bn``, ``K % bk`` must
    all be 0.  Raises ``ValueError`` for a tiling with no instantiation or
    whose tiles do not fit 227 KB, and for operands the kernel does not
    take (not CUDA, not float32/bfloat16, not contiguous row-major, not
    16-byte aligned).
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a (M, K) and b (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"(M, N, K) = {(M, N, K)} is not a multiple of the "
                         f"tiling {(bm, bn, bk)}")
    if not supported(bm, bn, bk, a.element_size()):
        raise ValueError(f"no instantiation of tiling {(bm, bn, bk)} for "
                         f"{a.dtype} (supported: {TILINGS}, tiles within "
                         f"{SMEM_BUDGET} bytes)")
    if a.device.type != "cuda":
        raise ValueError(f"blocked_matmul runs on CUDA tensors, got {a.device}")
    if a.dtype not in DTYPE_CODES:
        raise TypeError(f"blocked_matmul takes float32 or bfloat16, got {a.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or t.dtype != a.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{a.dtype} on {a.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        status = _launcher()(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk,
            DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(status, "blocked_matmul")
    blocked_matmul.launches += 1
    return out


#: launches of the GEMM kernel since the last reset
blocked_matmul.launches = 0


def traffic_model(
    M: int, N: int, K: int, bm: int, bn: int, bk: int, itemsize: int = 2
) -> dict[str, float]:
    """Analytic device-memory traffic and shared-memory footprint of a tiling.

    Every A tile is read N/bn times and every B tile M/bm times: the
    reference's count, bit for bit (``hbm_bytes``, ``flops``,
    ``arithmetic_intensity``).  It counts every re-read as device-memory
    traffic; on an H100 many of them are served by the 50 MB L2, which the
    model has no term for.  ``smem_bytes`` is what one block of the CUDA
    kernel allocates (the f32 accumulator is in registers): in bf16
    (itemsize 2), :func:`ring_stages` stages of one A tile (bm, bk) and one
    B tile (bk, bn), unpadded (TMA swizzles them), with two mbarriers a
    stage, plus 1024 bytes of alignment (``Ring`` in
    csrc/blocked_matmul.cu); for any other itemsize, the f32 route's one
    synchronous stage, an A tile (bm, bk + pad) and a B tile (bk, bn + pad)
    with each row padded by 16 bytes.
    """
    a_reads = M * K * (N // bn)
    b_reads = K * N * (M // bm)
    c_writes = M * N
    if itemsize == 2:
        smem = RING_ALIGN + ring_stages(bm, bn, bk) * (
            (bm * bk + bk * bn) * 2 + RING_BARRIER_BYTES)
    else:
        smem = (bm * bk + bk * bn) * itemsize + 16 * (bm + bk)
    flops = 2.0 * M * N * K
    traffic = (a_reads + b_reads + c_writes) * itemsize
    return {
        "hbm_bytes": float(traffic),
        "smem_bytes": float(smem),
        "flops": flops,
        "arithmetic_intensity": flops / traffic,
    }


def best_tiling(
    M: int, N: int, K: int,
    smem_budget: int = SMEM_BUDGET,
    itemsize: int = 2,
    candidates=TILINGS,
) -> tuple[int, int, int]:
    """The tiling with the highest arithmetic intensity (then the least
    shared memory) among ``candidates`` that divide the shape and fit
    ``smem_budget``; raises ``ValueError`` when none does."""
    best = None
    for bm, bn, bk in candidates:
        if M % bm or N % bn or K % bk:
            continue
        t = traffic_model(M, N, K, bm, bn, bk, itemsize)
        if t["smem_bytes"] > smem_budget:
            continue
        key = (t["arithmetic_intensity"], -t["smem_bytes"])
        if best is None or key > best[0]:
            best = (key, (bm, bn, bk))
    if best is None:
        raise ValueError(f"no tiling in {candidates} divides {(M, N, K)} "
                         f"within {smem_budget} bytes")
    return best[1]
