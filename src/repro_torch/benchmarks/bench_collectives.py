"""Paper Figs. 18/19: collective scaling (all-reduce / all-gather) by
buffer size and by axis locality.

Counterpart of the reference's ``benchmarks/bench_collectives.py``: the
paper's finding (the Superchip's locality matters more than the memory
type) maps to the axis a collective runs over, ``model`` (NVLink) against
``pod`` (InfiniBand).  Measured: all-reduce (``psum``) and all-gather over
each axis of a (2, n/2) ``pod`` x ``model`` mesh of gloo ranks on the CPU;
NCCL between cards needs several cards and prints a skip row.  Analytic:
the per-rank algorithmic bandwidth of each axis from
:func:`~repro_torch.core.datapath.collective_bound`.

    python -m repro_torch.benchmarks.run --only bench_collectives --device cpu
"""

from __future__ import annotations

from repro_torch.benchmarks.common import emit, run_with_ranks
from repro_torch.core.datapath import collective_bound
from repro_torch.core.hardware import Link

CODE = """
from repro_torch.launch.mesh import make_mesh_for
mesh = make_mesh_for((2, world // 2), ("pod", "model"))
for op in ("psum", "all_gather"):
    for axis in ("model", "pod"):
        group, k = mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))
        for log2 in (16, 22):
            n = 2 ** log2 // 4
            x = torch.ones(n)
            outs = list(torch.empty(k, n).unbind(0))
            def f():
                if op == "psum":
                    dist.all_reduce(x, group=group)
                else:
                    dist.all_gather(outs, x, group=group)
            f()
            dist.barrier()
            reps = 10
            t0 = time.perf_counter()
            for _ in range(reps):
                f()
            dist.barrier()
            dt = (time.perf_counter() - t0) / reps
            if rank == 0:
                print(f"measured_{op}[{axis},{n * 4}B],{dt * 1e6:.2f},"
                      f"{n * 4 / dt / 1e9:.2f}GB/s")
"""

#: (axis, link, size) of the analytic rows: the reference's production
#: mesh, 16 x 16 over NVLink-class links and 2 pods over InfiniBand
AXES = (("model", Link.ICI, 16), ("data", Link.ICI, 16), ("pod", Link.DCN, 2))


def measured(n: int = 8) -> list[str]:
    """The measured rows over ``n`` gloo ranks (a (2, n/2) mesh)."""
    out = run_with_ranks(CODE, n)
    return [line for line in out.splitlines() if line.startswith("measured_")]


def analytic() -> None:
    for kind in ("all_reduce", "all_gather"):
        for axis, link, size in AXES:
            bw = collective_bound(size, link, kind)
            for nbytes in (2**20, 2**26, 2**32):
                t = nbytes / bw
                emit(f"analytic_{kind}[{axis},{nbytes}B]", t * 1e6,
                     f"{nbytes / t / 1e9:.1f}GB/s algo-bw")


def main(device=None) -> None:
    for row in measured():
        print(row)
    emit("collectives_cards", 0.0,
         "skipped: NCCL between cards needs several cards; the measured rows are "
         "gloo ranks on the CPU")
    analytic()


if __name__ == "__main__":
    main()
