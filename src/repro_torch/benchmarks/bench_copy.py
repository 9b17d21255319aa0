"""Paper Figs. 5/9/10: copy throughput across (source, destination)
placement pairs.

Counterpart of the reference's ``benchmarks/bench_copy.py``.  Measured:
``Tensor.copy_`` between device memory and pinned host memory, which is
``cudaMemcpyAsync`` on the current stream (the reference's ``device_put``
between memory kinds).  On the card the pairs are those with a device
end: a copy between two host buffers is a host ``memcpy``, which the
card's clock cannot time.
On the card the sweep adds 256 MiB, past the 50 MB L2.  Analytic: the copy
matrix with each bound's limiting link."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import emit, kinds, l2_note, placed
from repro_torch.core import MemoryTier, copy_bound
from repro_torch.core.membench import measure

SIZES = [2**22, 2**26]           # 4 MiB, 64 MiB: the reference's
CUDA_SIZES = SIZES + [2**28]     # and 256 MiB on the card


def main(device: str | torch.device | None = None) -> None:
    dev = resolve_device(device)
    for src in kinds(dev):
        for dst in kinds(dev):
            if "device" not in (src, dst):
                continue
            for nbytes in CUDA_SIZES if dev.type == "cuda" else SIZES:
                x = placed(nbytes // 4, src, dev)
                y = placed(nbytes // 4, dst, dev, fill=0.0)
                note = l2_note(nbytes, dev) if src == dst == "device" else ""
                m = measure(
                    lambda x=x, y=y: y.copy_(x, non_blocking=True),
                    name=f"copy[{src}->{dst},{nbytes}]", nbytes=nbytes,
                    device=dev,
                )
                emit(m.name, m.us_per_call, f"{m.gbps:.2f}GB/s{note}")
                del x, y

    # analytic copy matrix (Fig. 5/9 bound rows)
    tiers = [t for t in MemoryTier if t != MemoryTier.VMEM]
    for src in tiers:
        for dst in tiers:
            b = copy_bound(src, dst)
            emit(
                f"analytic_copy[{src}->{dst}]",
                b.latency * 1e6,
                f"{b.bandwidth/1e9:.1f}GB/s via {b.limiting_link}",
            )


if __name__ == "__main__":
    main()
