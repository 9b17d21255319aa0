"""Paper Fig. 13: ping-pong latency between processing units.

Counterpart of the reference's ``benchmarks/bench_pingpong.py``: the CAS
ping-pong becomes a send/recv permute between ranks at increasing
distance, timed as a round trip (2x one permute).  Measured on gloo ranks
on the CPU (:func:`~repro_torch.benchmarks.common.run_with_ranks`, the
reference's forced host devices); NCCL between cards needs several cards
and prints a skip row.  The analytic rows are the hardware model's
ladder: NVLink 4 hops (``Link.ICI``), InfiniBand (``Link.DCN``), PCIe to
the host (``Link.PCIE``).

    python -m repro_torch.benchmarks.run --only bench_pingpong --device cpu
"""

from __future__ import annotations

from repro_torch.benchmarks.common import emit, run_with_ranks
from repro_torch.core.hardware import Link, get_active_system

#: the permute's distances (ranks apart), the reference's
DISTANCES = (1, 2, 4)

CODE = """
x = torch.full((1,), float(rank))
y = torch.empty(1)
for d in {distances}:
    def permute(src):
        ops = [dist.P2POp(dist.isend, src, (rank + d) % world),
               dist.P2POp(dist.irecv, y, (rank - d) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return y.clone()
    out = permute(x)
    dist.barrier()
    n = 30
    t0 = time.perf_counter()
    for _ in range(n):
        out = permute(out)
    dist.barrier()
    dt = 2 * (time.perf_counter() - t0) / n
    if rank == 0:
        print(f"pingpong[dist={{d}}],{{dt * 1e6:.2f}},round-trip(2x one-way)")
"""


def measured(n: int = 8) -> list[str]:
    """The measured rows over ``n`` gloo ranks, at the distances below
    ``n``."""
    dists = tuple(d for d in DISTANCES if d < n)
    out = run_with_ranks(CODE.format(distances=dists), n)
    return [line for line in out.splitlines() if line.startswith("pingpong[")]


def analytic() -> None:
    """The ladder: 1, 2, 4, 8 NVLink hops, one InfiniBand hop, PCIe."""
    c = get_active_system()
    for hops in (1, 2, 4, 8):
        emit(f"analytic_pingpong[ici,{hops}hops]", 2 * hops * c.link_latency(Link.ICI) * 1e6,
             "round-trip")
    emit("analytic_pingpong[dcn]", 2 * c.link_latency(Link.DCN) * 1e6, "round-trip")
    emit("analytic_pingpong[host]", 2 * c.link_latency(Link.PCIE) * 1e6, "round-trip")


def main(device=None) -> None:
    for row in measured():
        print(row)
    emit("pingpong_cards", 0.0,
         "skipped: NCCL between cards needs several cards; the measured rows are "
         "gloo ranks on the CPU")
    analytic()


if __name__ == "__main__":
    main()
