"""Paper Fig. 4: managed (page-migrating) vs system (fine-grained) memory.

Counterpart of the reference's ``benchmarks/bench_managed_vs_system.py``.
Measured: a buffer in pinned host memory touched k times (a read of every
element by ``csrc/membench.cu``), either migrated to device memory once
and then touched there, or re-fetched to the device before every touch;
the crossover in k reproduces the figure's shape.  On the card the
buffer is 32 MiB (the reference's) and 256 MiB, past the 50 MB L2.
Analytic: the closed-form crossover from the datapath model."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import emit, placed
from repro_torch.core import MemoryTier, migration_crossover_touches, streaming_time
from repro_torch.core.membench import measure
from repro_torch.kernels import ops

SIZES = [2**25]                  # 32 MiB: the reference's
CUDA_SIZES = SIZES + [2**28]     # and 256 MiB on the card


def main(device: str | torch.device | None = None) -> None:
    dev = resolve_device(device)
    host_kind = "pinned_host" if dev.type == "cuda" else "device"
    for nbytes in CUDA_SIZES if dev.type == "cuda" else SIZES:
        x_host = placed(nbytes // 4, host_kind, dev)
        x_dev = placed(nbytes // 4, "device", dev, fill=0.0)

        def touch(v):
            return ops.stream_read(v, device=dev)

        for k in (1, 4, 16, 64):
            def migrated(k=k):
                x_dev.copy_(x_host, non_blocking=True)   # one bulk migration
                for _ in range(k):
                    touch(x_dev)

            def streamed(k=k):
                for _ in range(k):
                    x_dev.copy_(x_host, non_blocking=True)   # re-fetch per touch
                    touch(x_dev)

            m1 = measure(migrated, name=f"migrated[{nbytes},k={k}]", repeats=3,
                         device=dev)
            m2 = measure(streamed, name=f"streamed[{nbytes},k={k}]", repeats=3,
                         device=dev)
            emit(m1.name, m1.us_per_call,
                 f"{nbytes*k/m1.mean_s/1e9:.2f}GB/s-effective")
            emit(m2.name, m2.us_per_call,
                 f"{nbytes*k/m2.mean_s/1e9:.2f}GB/s-effective")
        del x_host, x_dev

    # analytic crossover (the paper's "~128 iterations" point)
    x = migration_crossover_touches(MemoryTier.HOST)
    emit("analytic_crossover[host]", 0.0, f"{x:.1f}touches")
    for k in (1, 4, 16, 64, 256):
        t_stream = streaming_time(2**30, MemoryTier.HOST, touches=k)
        t_mig = streaming_time(2**30, MemoryTier.HBM, touches=k) + streaming_time(
            2**30, MemoryTier.HOST, touches=1
        )
        winner = "migrate" if t_mig < t_stream else "stream"
        emit(f"analytic_managed[k={k}]", min(t_mig, t_stream) * 1e6, winner)


if __name__ == "__main__":
    main()
