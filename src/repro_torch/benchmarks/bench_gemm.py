"""Paper Figs. 15/16 + Table III: GEMM throughput vs dtype and operand
placement.

Counterpart of the reference's ``benchmarks/bench_gemm.py``.  Measured:
``torch.matmul`` (the library row, the reference's ``jnp.dot``) and the
CUDA ``blocked_matmul`` (``ops.matmul``) over every tiling it has, each
with the traffic model's arithmetic intensity.  On the card it runs at the
paper's size, N = 16384 in bf16 (512 MB a matrix), and N = 8192 in f32
(CUDA-core FMAs; TF32 off), which keeps the run short; on the CPU at the
reference's N = 512, where ``ops.matmul`` is the plain version.  The
operands are a ~ N(0, 1) and b ~ N(0, 1) / sqrt(N), so every output has
an RMS of about 1 at every N and a check of the timed calls against the
plain version (:func:`inputs`, :func:`tilings`) holds them to one
tolerance.
Analytic: the datapath verdict for the paper's experiment at N = 16384,
per dtype (Table III) and per operand placement (Fig. 15's colour map),
under the active system.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import emit
from repro_torch.core import MemoryTier, get_active_system, read_bound
from repro_torch.core.membench import measure
from repro_torch.kernels import ops
from repro_torch.kernels.blocked_matmul import TILINGS, best_tiling, supported, traffic_model

#: (N, dtype) the measured rows run at, by device type
SIZES = {
    "cuda": ((16384, torch.bfloat16), (8192, torch.float32)),
    "cpu": ((512, torch.float32), (512, torch.bfloat16)),
}

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def inputs(N: int, dtype: torch.dtype, device: torch.device):
    """The study's (N, N) operands on ``device``, made from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(N, N, generator=gen, device=device)
    b = torch.randn(N, N, generator=gen, device=device) * N ** -0.5
    return a.to(dtype), b.to(dtype)


def tilings(N: int, itemsize: int) -> list[tuple[int, int, int]]:
    """The kernel's tilings the study times at (N, N, N) for ``itemsize``."""
    return [t for t in TILINGS
            if not (N % t[0] or N % t[1] or N % t[2]) and supported(*t, itemsize)]


def measured(device: str | torch.device | None = None) -> None:
    dev = resolve_device(device)
    for N, dtype in SIZES[dev.type]:
        name = _NAMES[dtype]
        a, b = inputs(N, dtype, dev)
        m = measure(lambda: torch.matmul(a, b), name=f"torch_gemm[{N},{name}]",
                    flops=2 * N**3, repeats=5, device=dev)
        emit(m.name, m.us_per_call, f"{m.tflops:.3f}TF/s")
        for bm, bn, bk in tilings(N, a.element_size()):
            m = measure(
                lambda: ops.matmul(a, b, bm=bm, bn=bn, bk=bk),
                name=f"blocked_gemm[{N},{name},bm{bm},bn{bn},bk{bk}]",
                flops=2 * N**3, repeats=5, device=dev,
            )
            t = traffic_model(N, N, N, bm, bn, bk, a.element_size())
            emit(m.name, m.us_per_call,
                 f"{m.tflops:.3f}TF/s AI={t['arithmetic_intensity']:.1f}flops/B")
        del a, b


def analytic(tiling: tuple[int, int, int] | None = None) -> None:
    """The verdict rows at N = 16384 under the active system, for
    ``tiling`` (default: :func:`best_tiling`'s pick for the H100)."""
    c = get_active_system().chip
    N = 16384  # paper uses 4 GB square matrices; bf16 16k^2 = 512 MB each
    flops = 2.0 * N**3
    bm, bn, bk = tiling or best_tiling(N, N, N)

    # Table III analogue: dtype sweep, HBM-resident
    for dtype, peak in c.peak_flops_by_dtype.items():
        itemsize = {"bfloat16": 2, "float32": 4, "int8": 1}[dtype]
        t = traffic_model(N, N, N, bm, bn, bk, itemsize=itemsize)
        t_mem = t["hbm_bytes"] / c.hbm_bandwidth
        t_cmp = flops / peak
        bound = "compute" if t_cmp > t_mem else "memory"
        emit(
            f"analytic_gemm[hbm,{dtype}]",
            max(t_cmp, t_mem) * 1e6,
            f"{flops/max(t_cmp,t_mem)/1e12:.1f}TF/s {bound}-bound",
        )

    # Fig. 15 analogue: operand placement sweep at bf16.  Reads dominate
    # (the paper's key asymmetry): destination placement never appears in
    # the bound because C is written once but A/B stream repeatedly.
    reuse_a = N // bn   # times each A byte is re-read
    reuse_b = N // bm
    for pa in (MemoryTier.HBM, MemoryTier.HOST, MemoryTier.PEER_HBM):
        for pb in (MemoryTier.HBM, MemoryTier.HOST, MemoryTier.PEER_HBM):
            nbytes = N * N * 2
            t_a = nbytes * reuse_a / read_bound(pa).bandwidth
            t_b = nbytes * reuse_b / read_bound(pb).bandwidth
            t_cmp = flops / c.peak_bf16_flops
            t_total = max(t_cmp, t_a + t_b)
            bound = "compute" if t_cmp >= t_a + t_b else "memory"
            emit(
                f"analytic_gemm[A={pa},B={pb}]",
                t_total * 1e6,
                f"{flops/t_total/1e12:.1f}TF/s {bound}-bound",
            )


def main(device: str | torch.device | None = None) -> None:
    measured(device)
    analytic()


if __name__ == "__main__":
    main()
