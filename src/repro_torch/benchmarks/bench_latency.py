"""Paper Figs. 11/12: memory access latency via pointer chase.

Counterpart of the reference's ``benchmarks/bench_latency.py``.  Measured:
a dependent-load chain (each load's address is the previous load's value)
over a random cyclic permutation, the multichase method.  On the card it
is one thread of ``csrc/membench.cu`` walking device memory or pinned host
memory read in place, and the sweep adds 256 MiB, past the 50 MB L2, so
the steps from L1 to L2 to HBM show; on the CPU it is ``ref.chase``, one
indexing op per load.  Unlike the reference's chase, which restarts at
index 0, each call goes on where the last one stopped: on the card a
restarted chain of 2048 loads would find its lines in L2 at every size.
Analytic: per-tier latencies from the hardware model."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import emit, kinds, l2_note
from repro_torch.core import MemoryTier, get_active_system, read_bound
from repro_torch.core.membench import measure
from repro_torch.kernels import ops

SIZES = [2**12, 2**16, 2**20, 2**23]   # elements (x4 bytes): the reference's
CUDA_SIZES = SIZES + [2**26]           # and 256 MiB on the card
CHAIN = 2048                            # dependent loads per call


def cyclic_permutation(n: int, rng: np.random.Generator) -> np.ndarray:
    """perm with one cycle through all n entries (defeats prefetch)."""
    perm = np.empty(n, np.int32)
    order = rng.permutation(n)
    perm[order[:-1]] = order[1:]
    perm[order[-1]] = order[0]
    return perm


def main(device: str | torch.device | None = None) -> None:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    for n in CUDA_SIZES if dev.type == "cuda" else SIZES:
        perm = torch.from_numpy(cyclic_permutation(n, rng))
        for kind in kinds(dev):
            x = perm.to(dev) if kind == "device" else perm.pin_memory()
            pos = torch.zeros((), dtype=torch.int32, device=dev)
            note = l2_note(n * 4, dev) if kind == "device" else ""
            m = measure(lambda x=x, pos=pos: ops.chase(x, CHAIN, pos, device=dev),
                        name=f"chase[{kind},{n*4}B]", repeats=5, device=dev)
            emit(m.name, m.us_per_call, f"{m.mean_s/CHAIN*1e9:.1f}ns/load{note}")
            del x

    for t in MemoryTier:
        b = read_bound(t) if t != MemoryTier.VMEM else None
        lat = (
            get_active_system().chip.vmem_latency
            if t == MemoryTier.VMEM
            else b.latency
        )
        emit(f"analytic_latency[{t}]", lat * 1e6, f"{lat*1e9:.0f}ns")


if __name__ == "__main__":
    main()
