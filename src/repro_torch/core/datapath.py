"""Datapath model: theoretical bandwidth/latency bounds per memory operation.

Counterpart of ``repro/core/datapath.py``, copied whole (pure Python): the
same functions give the same bounds under the same :class:`SystemSpec`
values.

This is the paper's central analytical device (Fig. 3): for an operation
that moves bytes between physical memories, enumerate the interconnect
segments the data traverses; the bound is the bandwidth of the *slowest*
segment, and any segment traversed **twice** by the same operation (e.g.
a copy whose source and destination both sit behind the same link)
contributes at **half** its bandwidth.

The paper instantiates this for {Grace, Hopper} x {DDR, HBM, peer variants};
here it is instantiated for one H100 against the tiers of
:class:`repro_torch.core.hardware.MemoryTier`.  It powers the analytic
mode of every microbenchmark and the calibration replay.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

from repro_torch.core.hardware import (
    Link,
    MemoryTier,
    SystemSpec,
    get_active_system,
)

# ---------------------------------------------------------------------------
# Datapaths: tier -> sequence of links between the compute unit and the tier.
# A read of tier T traverses path(T) once; a copy src->dst traverses
# path(src) + path(dst), and shared links count twice (paper Fig. 3).
# ---------------------------------------------------------------------------

_PATHS: dict[MemoryTier, tuple[Link, ...]] = {
    MemoryTier.VMEM: (Link.VMEM_BUS,),
    MemoryTier.HBM: (Link.HBM_BUS,),
    MemoryTier.HOST: (Link.PCIE,),
    MemoryTier.PEER_HBM: (Link.ICI, Link.HBM_BUS),
    MemoryTier.PEER_HOST: (Link.ICI, Link.PCIE),
    MemoryTier.REMOTE_HBM: (Link.DCN, Link.HBM_BUS),
}


def path(tier: MemoryTier) -> tuple[Link, ...]:
    """Links between this chip's compute units and ``tier``."""
    return _PATHS[tier]


@dataclasses.dataclass(frozen=True)
class Bound:
    """A datapath bound: bandwidth + the link that limits it.

    ``fraction(measured)`` is the paper's headline metric — achieved
    bandwidth over the datapath bound, localizing inefficiency to
    ``limiting_link`` rather than to "the machine".
    """

    bandwidth: float                 # bytes/s
    limiting_link: Link
    latency: float                   # seconds, sum of segment latencies
    traversals: tuple[tuple[Link, int], ...]  # (link, times traversed)

    def fraction(self, measured_bandwidth: float) -> float:
        return measured_bandwidth / self.bandwidth

    def time(self, nbytes: float) -> float:
        """Predicted time to move ``nbytes`` through this datapath."""
        return self.latency + nbytes / self.bandwidth


def _bound_from_traversals(
    traversals: Counter[Link], system: SystemSpec | None
) -> Bound:
    """min over links of bw/traversals — the twice-traversed-halves rule."""
    system = system if system is not None else get_active_system()
    if not traversals:
        raise ValueError("empty datapath")
    best_bw = float("inf")
    limiting = None
    latency = 0.0
    for link, count in traversals.items():
        eff = system.link_bandwidth(link) / count
        latency += system.link_latency(link) * count
        if eff < best_bw:
            best_bw = eff
            limiting = link
    return Bound(
        bandwidth=best_bw,
        limiting_link=limiting,
        latency=latency,
        traversals=tuple(sorted(traversals.items())),
    )


def read_bound(
    tier: MemoryTier, system: SystemSpec | None = None
) -> Bound:
    """Bound for this chip reading from ``tier`` (paper Fig. 3, left)."""
    return _bound_from_traversals(Counter(path(tier)), system)


def write_bound(
    tier: MemoryTier, system: SystemSpec | None = None
) -> Bound:
    """Bound for this chip writing to ``tier``.

    Symmetric with reads in this model; the *measured* asymmetry the paper
    reports (write < read on some paths) is an efficiency effect, which is
    exactly why bounds and measurements are kept separate.
    """
    return _bound_from_traversals(Counter(path(tier)), system)


def copy_bound(
    src: MemoryTier,
    dst: MemoryTier,
    system: SystemSpec | None = None,
) -> Bound:
    """Bound for a chip-driven copy ``src -> dst``.

    Each link on the source path and on the destination path is traversed
    once; links appearing on both are traversed twice and contribute at
    half bandwidth (paper: DDR->DDR over C2C is bounded at 250 GB/s, half
    of the 450 GB/s C2C link; H100: HOST->HOST over one PCIe link halves,
    HBM->HBM through the card halves the HBM bus).
    """
    traversals: Counter[Link] = Counter(path(src))
    traversals.update(path(dst))
    return _bound_from_traversals(traversals, system)


def collective_bound(
    axis_size: int,
    axis_link: Link,
    kind: str,
    system: SystemSpec | None = None,
) -> float:
    """Per-chip algorithmic bandwidth bound of a ring collective.

    Returns effective bytes/s *of payload* per chip: a ring all-reduce of
    B bytes moves ``2*(N-1)/N * B`` bytes over the chip's slowest on-path
    link, etc.
    """
    system = system if system is not None else get_active_system()
    link_bw = system.link_bandwidth(axis_link)
    n = axis_size
    if n <= 1:
        return float("inf")
    factor = {
        "all_reduce": 2.0 * (n - 1) / n,
        "all_gather": (n - 1) / n,
        "reduce_scatter": (n - 1) / n,
        "all_to_all": (n - 1) / n,
        "collective_permute": 1.0,
    }[kind]
    return link_bw / factor


# ---------------------------------------------------------------------------
# Wire-byte factors of ring collectives.
# ---------------------------------------------------------------------------

def wire_bytes(kind: str, payload_bytes: float, group_size: int) -> float:
    """Bytes a single chip puts on the wire for one collective.

    ``payload_bytes`` is the per-chip shard size (operand size for
    reduce-scatter/all-reduce, output size for all-gather).
    Ring-algorithm accounting, matching ``collective_bound``.
    """
    n = max(group_size, 1)
    if n == 1:
        return 0.0
    factor = {
        "all-reduce": 2.0 * (n - 1) / n,
        "all-gather": (n - 1) / n,
        "reduce-scatter": (n - 1) / n,
        "all-to-all": (n - 1) / n,
        "collective-permute": 1.0,
        "ragged-all-to-all": (n - 1) / n,
    }[kind]
    return payload_bytes * factor


def bound_matrix(
    op: str,
    tiers: Sequence[MemoryTier] | None = None,
    system: SystemSpec | None = None,
) -> dict[str, dict[str, float]]:
    """Paper-Fig.-3-style matrix of GB/s bounds.

    ``op`` is 'read', 'write' (vector keyed by tier) or 'copy' (full
    src x dst matrix).
    """
    tiers = list(tiers or [t for t in MemoryTier if t != MemoryTier.VMEM])
    out: dict[str, dict[str, float]] = {}
    if op in ("read", "write"):
        fn = read_bound if op == "read" else write_bound
        out[op] = {str(t): fn(t, system).bandwidth / 1e9 for t in tiers}
        return out
    if op == "copy":
        for src in tiers:
            out[str(src)] = {
                str(dst): copy_bound(src, dst, system).bandwidth / 1e9
                for dst in tiers
            }
        return out
    raise ValueError(f"unknown op {op!r}")


def streaming_time(
    nbytes: float,
    tier: MemoryTier,
    system: SystemSpec | None = None,
    *,
    touches: int = 1,
) -> float:
    """Time for a compute step that touches ``nbytes`` living in ``tier``.

    ``touches`` models re-reads within the step (the paper's Fig. 4 axis:
    repeated device-side touches amortize migration).  Resident-vs-streamed
    policy comparison (Table II analogue):

    * resident in HBM: ``touches * nbytes / hbm_bw``
    * streamed from ``tier``: pay the tier path once per touch.
    """
    b = read_bound(tier, system)
    return touches * (nbytes / b.bandwidth) + b.latency


def migration_crossover_touches(
    tier: MemoryTier, system: SystemSpec | None = None
) -> float:
    """Touches after which migrate-to-HBM beats streaming from ``tier``.

    Closed form of the paper's Fig. 4 experiment: migration costs one copy
    ``tier -> HBM`` plus ``touches`` HBM reads; streaming costs ``touches``
    reads over the tier path.  Returns the break-even touch count.
    """
    system = system if system is not None else get_active_system()
    hbm = system.link_bandwidth(Link.HBM_BUS)
    tier_bw = read_bound(tier, system).bandwidth
    cp = copy_bound(tier, MemoryTier.HBM, system).bandwidth
    if tier_bw >= hbm:
        return float("inf")
    # t/tier_bw >= 1/cp + t/hbm  =>  t >= (1/cp) / (1/tier_bw - 1/hbm)
    return (1.0 / cp) / (1.0 / tier_bw - 1.0 / hbm)
