"""Paper Fig. 14: internode bandwidth by message size and number of
injection streams.

Counterpart of the reference's ``benchmarks/bench_internode.py``.
Measured: an all-reduce over ``pod`` of a (2, n/2) ``pod`` x ``data`` mesh
of gloo ranks on the CPU at 2^16, 2^20 and 2^24 bytes (every data column
reduces at once, as every chip of a pod injects); NCCL over InfiniBand
needs several hosts and prints a skip row.  Analytic: the alpha-beta
model of ``Link.DCN`` over message size for 1, 2 and 4 streams.

    python -m repro_torch.benchmarks.run --only bench_internode --device cpu
"""

from __future__ import annotations

from repro_torch.benchmarks.common import emit, run_with_ranks
from repro_torch.core.hardware import Link, get_active_system

CODE = """
from repro_torch.launch.mesh import make_mesh_for
mesh = make_mesh_for((2, world // 2), ("pod", "data"))
group = mesh.get_group("pod")
for log2 in (16, 20, 24):
    n = 2 ** log2 // 4
    x = torch.ones(n)
    dist.all_reduce(x, group=group)
    dist.barrier()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(x, group=group)
    dist.barrier()
    dt = (time.perf_counter() - t0) / reps
    if rank == 0:
        print(f"measured_podreduce[{n * 4}B],{dt * 1e6:.2f},{n * 4 / dt / 1e9:.2f}GB/s")
"""


def measured(n: int = 8) -> list[str]:
    """The measured rows over ``n`` gloo ranks (a (2, n/2) mesh)."""
    out = run_with_ranks(CODE, n)
    return [line for line in out.splitlines() if line.startswith("measured_podreduce[")]


def analytic() -> None:
    """alpha + size / (beta * streams) over 2^12..2^28 bytes."""
    system = get_active_system()
    beta, alpha = system.link_bandwidth(Link.DCN), system.link_latency(Link.DCN)
    for streams in (1, 2, 4):
        for size in (2**12, 2**16, 2**20, 2**24, 2**28):
            t = alpha + size / (beta * streams)
            emit(f"analytic_internode[{streams}streams,{size}B]", t * 1e6,
                 f"{size / t / 1e9:.2f}GB/s")


def main(device=None) -> None:
    for row in measured():
        print(row)
    emit("internode_cards", 0.0,
         "skipped: NCCL over InfiniBand needs several hosts; the measured rows are "
         "gloo ranks on the CPU")
    analytic()


if __name__ == "__main__":
    main()
