"""Paper Figs. 2/7/8: read/write bandwidth per memory placement.

Counterpart of the reference's ``benchmarks/bench_membw.py``.  Measured:
``csrc/membench.cu``'s streaming read (sum) and write (fill) over buffers
in device memory and in pinned host memory, which the card reads and
writes in place over PCIe (on the CPU: ``torch.sum`` / ``fill_`` over
host DRAM).  On the card the sweep adds 1 GiB, past the 50 MB L2; smaller
device rows are labelled L2-resident.  Pinned host rows are not: on the
H100 a 1 MiB pinned buffer read again and again reads no faster than
1 GiB does, so L2 does not serve them.  Analytic: the tier table with
bound bandwidths and latencies."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import emit, kinds, l2_note, placed
from repro_torch.core import MemoryTier, read_bound, write_bound
from repro_torch.core.membench import dispatch_overhead, measure
from repro_torch.kernels import ops

SIZES = [2**20, 2**24, 2**27]    # 1 MiB .. 128 MiB: the reference's
CUDA_SIZES = SIZES + [2**30]     # and 1 GiB on the card


def main(device: str | torch.device | None = None) -> None:
    dev = resolve_device(device)
    emit("dispatch_overhead", dispatch_overhead(device=dev) * 1e6, "per-call")

    for kind in kinds(dev):
        for nbytes in CUDA_SIZES if dev.type == "cuda" else SIZES:
            x = placed(nbytes // 4, kind, dev)
            note = l2_note(nbytes, dev) if kind == "device" else ""
            m = measure(
                lambda x=x: ops.stream_read(x, device=dev),
                name=f"read[{kind},{nbytes}]", nbytes=nbytes, device=dev,
            )
            emit(m.name, m.us_per_call, f"{m.gbps:.2f}GB/s{note}")
            m = measure(
                lambda x=x: ops.stream_fill(x, 2.0, device=dev),
                name=f"write[{kind},{nbytes}]", nbytes=nbytes, device=dev,
            )
            emit(m.name, m.us_per_call, f"{m.gbps:.2f}GB/s{note}")
            del x

    # analytic tier table (Fig. 7's bound rows)
    for t in MemoryTier:
        if t == MemoryTier.VMEM:
            continue
        rb, wb = read_bound(t), write_bound(t)
        emit(
            f"analytic_read[{t}]", rb.latency * 1e6,
            f"{rb.bandwidth/1e9:.1f}GB/s",
        )
        emit(
            f"analytic_write[{t}]", wb.latency * 1e6,
            f"{wb.bandwidth/1e9:.1f}GB/s",
        )


if __name__ == "__main__":
    main()
