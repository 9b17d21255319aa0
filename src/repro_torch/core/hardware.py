"""H100 hardware model: the single source of truth for the port's roofline constants.

Counterpart of ``repro/core/hardware.py``.  The paper characterizes the
Quad GH200 node by enumerating its processing units, physical memories and
interconnects (paper Fig. 1) and deriving a theoretical bound for every
datapath (paper Fig. 3).  The reference describes a TPU v5e pod; this
module describes one NVIDIA H100 SXM5 80 GB card, its PCIe host link, and
the NVLink and InfiniBand links of the peer and remote tiers.  It is
consumed by :mod:`repro_torch.core.datapath`, the benchmarks and
``chip_smoke.py``'s kernel bounds.

Field and enum names are the reference's, one to one, so a reference
``ChipSpec``'s fields build this one's.  Two keep their TPU names for that:
the ``VMEM`` tier and the ``vmem_*`` fields stand for the SM's shared
memory (the on-chip scratch a kernel stages tiles in), and the ``ICI``
link for NVLink between the cards of one host.

All bandwidths are bytes/second, latencies seconds, capacities bytes.
Each value names its source.  Rates and capacities come from NVIDIA's H100
data sheet (SXM5, dense, at the 700 W power limit); the latencies and the
host DRAM share are not on the data sheet and take public figures, which
calibration (:mod:`repro_torch.core.calibration`) replaces on the card.
On one card only device memory and pinned host memory exist; the peer and
remote tiers are analysis-only.

Provenance
----------

Every calibratable term carries a provenance tag:

* ``spec``     — the declarative constant below (the default);
* ``measured`` — rewritten from a microbenchmark via
  :meth:`SystemSpec.with_measurements`;
* ``override`` — pinned by hand via :meth:`SystemSpec.with_overrides`.

Consumers resolve their system through :func:`get_active_system` (or an
explicitly passed ``system=``); the spec-sheet baseline is the module's
default system and is what every process starts with.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Mapping

from repro_torch.core.warnings_registry import warn_once


class MemoryTier(str, enum.Enum):
    """Physical memory pools a tensor can live in, from the card's view.

    Mirrors the paper's {HBM, DDR, HBM-p, DDR-p} axis (Figs. 5, 7, 9).
    """

    VMEM = "vmem"            # on-chip: the SM's shared memory
    HBM = "hbm"              # local device memory (HBM3)
    HOST = "host"            # this card's host DRAM (pinned, over PCIe)
    PEER_HBM = "hbm_p"       # another card's HBM, same host (via NVLink)
    PEER_HOST = "host_p"     # another card's host DRAM (NVLink + PCIe)
    REMOTE_HBM = "hbm_r"     # a card's HBM on another host (InfiniBand)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class Link(str, enum.Enum):
    """Interconnects, the paper's 'datapath segments'."""

    HBM_BUS = "hbm_bus"      # HBM <-> SMs
    VMEM_BUS = "vmem_bus"    # shared memory <-> SM compute units
    PCIE = "pcie"            # host DRAM <-> card
    ICI = "ici"              # card <-> peer card (NVLink 4)
    DCN = "dcn"              # host <-> host, per card (InfiniBand)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One NVIDIA H100 SXM5 80 GB card."""

    name: str = "h100-sxm5-80gb"
    peak_bf16_flops: float = 989e12          # data sheet: 989 TFLOP/s bf16 dense
    hbm_bandwidth: float = 3.35e12           # data sheet: HBM3, 3.35 TB/s
    hbm_capacity: float = 80e9               # data sheet: 80 GB
    # Host DRAM per card: DGX H100 data sheet, 2 TB of system memory for
    # 8 cards.
    host_dram_capacity: float = 2e12 / 8
    # Shared memory one block may use: 227 KB (CUDA programming guide,
    # compute capability 9.0).
    vmem_capacity: float = 232_448
    # Derived: 32 banks x 4 B a clock per SM (CUDA programming guide) x
    # 132 SMs x 1.98 GHz maximum SM clock.
    vmem_bandwidth: float = 132 * 128 * 1.98e9
    ici_link_bandwidth: float = 450e9        # data sheet: NVLink 4, 900 GB/s = 450 each way
    ici_links_per_axis: int = 1              # one NVLink port group per peer collective
    pcie_bandwidth: float = 64e9             # data sheet: PCIe Gen5 x16, 128 GB/s = 64 a direction
    # One InfiniBand NDR port per card, 400 Gb/s (DGX H100 data sheet).
    dcn_bandwidth: float = 50e9
    # Latency terms (seconds), for the latency benchmarks (paper Figs.
    # 11-13).  None is on the data sheet; calibration and bench_latency
    # measure the first three on the card.
    # ~500 ns: a dependent load that misses the 50 MB L2, the order of the
    # pointer-chase latencies published for H100 (Chips and Cheese,
    # "Nvidia's H100: Funny L2, and Tons of Bandwidth", 2023).
    hbm_latency: float = 500e-9
    # ~30 SM clocks for a shared-memory load (Luo et al., "Benchmarking and
    # Dissecting the Nvidia Hopper GPU Architecture", arXiv:2402.13499).
    vmem_latency: float = 15e-9
    # ~1 us: the order of a PCIe round trip for a card's read of mapped
    # host memory.
    pcie_latency: float = 1.0e-6
    # ~1 us for a peer-card access over NVLink, ~2 us card to card across
    # hosts over InfiniBand with GPUDirect RDMA: the orders of published
    # peer-access and OSU latency results; analysis-only on one card.
    ici_hop_latency: float = 1.0e-6
    dcn_latency: float = 2.0e-6
    # Matmul dims should be multiples of this for full tensor-core use:
    # the 64-row tile of Hopper's warpgroup MMA (wgmma).
    mxu_dim: int = 64
    # Peak flops by dtype (GEMM study, paper Table III analogue).
    peak_flops_by_dtype: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {
            "bfloat16": 989e12,   # data sheet: tensor cores, dense
            "float32": 67e12,     # data sheet: CUDA cores (TF32 stays off)
            "int8": 1979e12,      # data sheet: tensor cores, dense TOPS
        }
    )


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """The cards one program drives: a one-card mesh by default."""

    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    mesh_shape: tuple[int, ...] = (1,)
    torus_wraparound: bool = False       # NVLink is switched, not a torus

    @property
    def num_chips(self) -> int:
        return math.prod(self.mesh_shape)

    def ici_hops(self, a: tuple[int, ...], b: tuple[int, ...]) -> int:
        """Manhattan hop distance between two chips on the (wrapped) mesh."""
        hops = 0
        for ax, (i, j) in enumerate(zip(a, b)):
            d = abs(i - j)
            if self.torus_wraparound:
                d = min(d, self.mesh_shape[ax] - d)
            hops += d
        return hops

    def bisection_bandwidth(self) -> float:
        """All-links bisection bandwidth of the mesh (for sanity checks)."""
        longest = max(self.mesh_shape)
        cross = self.num_chips // longest
        wrap = 2 if self.torus_wraparound else 1
        return cross * wrap * self.chip.ici_link_bandwidth


#: provenance values a calibratable term may carry
PROVENANCES = ("spec", "measured", "override")

#: Calibratable terms: name -> the :class:`ChipSpec` field it rewrites.
CALIBRATED_TERMS: dict[str, str] = {
    "peak_bf16_flops": "peak_bf16_flops",
    "hbm_bandwidth": "hbm_bandwidth",
    "vmem_bandwidth": "vmem_bandwidth",
    "pcie_bandwidth": "pcie_bandwidth",
    "ici_link_bandwidth": "ici_link_bandwidth",
    "dcn_bandwidth": "dcn_bandwidth",
    "hbm_latency": "hbm_latency",
    "vmem_latency": "vmem_latency",
    "pcie_latency": "pcie_latency",
    "ici_hop_latency": "ici_hop_latency",
    "dcn_latency": "dcn_latency",
}


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """The full target: ``num_pods`` hosts' worth of meshes (one card, one
    host by default).

    ``provenance`` maps each :data:`CALIBRATED_TERMS` name to
    ``spec | measured | override`` (absent -> ``spec``).  Instances are
    immutable: :meth:`with_measurements` / :meth:`with_overrides` derive
    a new spec with the terms rewritten and tagged.
    """

    pod: PodSpec = dataclasses.field(default_factory=PodSpec)
    num_pods: int = 1
    provenance: Mapping[str, str] = dataclasses.field(default_factory=dict)

    @property
    def num_chips(self) -> int:
        return self.pod.num_chips * self.num_pods

    @property
    def chip(self) -> ChipSpec:
        return self.pod.chip

    def link_bandwidth(self, link: Link) -> float:
        c = self.chip
        return {
            Link.HBM_BUS: c.hbm_bandwidth,
            Link.VMEM_BUS: c.vmem_bandwidth,
            Link.PCIE: c.pcie_bandwidth,
            Link.ICI: c.ici_link_bandwidth * c.ici_links_per_axis,
            Link.DCN: c.dcn_bandwidth,
        }[link]

    def link_latency(self, link: Link) -> float:
        c = self.chip
        return {
            Link.HBM_BUS: c.hbm_latency,
            Link.VMEM_BUS: c.vmem_latency,
            Link.PCIE: c.pcie_latency,
            Link.ICI: c.ici_hop_latency,
            Link.DCN: c.dcn_latency,
        }[link]

    # -- calibration surface ----------------------------------------------
    def term_value(self, term: str) -> float:
        """Current value of a calibratable term."""
        return getattr(self.chip, _term_field(term))

    def provenance_of(self, term: str) -> str:
        """``spec | measured | override`` for ``term`` (spec when never
        rewritten)."""
        _term_field(term)  # validate
        return self.provenance.get(term, "spec")

    def _derive(self, provenance: str, terms: Mapping[str, float]
                ) -> "SystemSpec":
        if provenance not in PROVENANCES:
            raise ValueError(
                f"unknown provenance {provenance!r}; one of {PROVENANCES}"
            )
        chip_updates = {}
        for term, value in terms.items():
            field = _term_field(term)
            value = float(value)
            if not value > 0.0:
                raise ValueError(
                    f"calibrated term {term} must be > 0, got {value!r}"
                )
            chip_updates[field] = value
        new_chip = dataclasses.replace(self.chip, **chip_updates)
        new_pod = dataclasses.replace(self.pod, chip=new_chip)
        new_prov = dict(self.provenance)
        new_prov.update({t: provenance for t in terms})
        return dataclasses.replace(self, pod=new_pod, provenance=new_prov)

    def with_measurements(self, **terms: float) -> "SystemSpec":
        """A new spec with ``terms`` rewritten from measurements and
        tagged ``measured`` (what :func:`repro_torch.core.calibration.
        calibrate` applies)."""
        return self._derive("measured", terms)

    def with_overrides(self, **terms: float) -> "SystemSpec":
        """A new spec with ``terms`` pinned by hand (``override``)."""
        return self._derive("override", terms)

    def describe_terms(self) -> dict[str, dict]:
        """Per-term ``{value, provenance}``, what ``calibration.json``
        records for every constant."""
        return {
            term: {
                "value": self.term_value(term),
                "provenance": self.provenance_of(term),
            }
            for term in CALIBRATED_TERMS
        }


def _term_field(term: str) -> str:
    try:
        return CALIBRATED_TERMS[term]
    except KeyError:
        raise KeyError(
            f"unknown calibratable term {term!r}; "
            f"one of {sorted(CALIBRATED_TERMS)}"
        ) from None


#: Spec-sheet baseline system (every term provenance ``spec``).
SPEC_SYSTEM = SystemSpec()

#: The process-wide system consumers resolve through get_active_system().
_ACTIVE_SYSTEM: SystemSpec = SPEC_SYSTEM


def get_active_system() -> SystemSpec:
    """The system every pricing path uses when no explicit ``system=`` is
    passed: the spec-sheet baseline until :func:`set_active_system`
    installs a calibrated one (``benchmarks.run --calibration``)."""
    return _ACTIVE_SYSTEM


def set_active_system(system: SystemSpec) -> SystemSpec:
    """Install ``system`` as the process-wide default; returns the
    previous one (restore it in tests)."""
    global _ACTIVE_SYSTEM
    if not isinstance(system, SystemSpec):
        raise TypeError(f"expected SystemSpec, got {type(system).__name__}")
    prev = _ACTIVE_SYSTEM
    _ACTIVE_SYSTEM = system
    return prev


#: Mesh-axis -> link map.  'model' and 'data' run over NVLink between the
#: cards of a host; 'pod' crosses hosts; the 'donor'/'donor_pod'
#: memory-donor axes ride NVLink and InfiniBand respectively: the paper's
#: "locality beats memory type" lesson (Fig. 19) as data.
AXIS_LINK: dict[str, Link] = {
    "model": Link.ICI,
    "data": Link.ICI,
    "pod": Link.DCN,
    "donor": Link.ICI,
    "donor_pod": Link.DCN,
}


def link_for_axis(axis: str, *, strict: bool = False) -> Link:
    """The physical link a mesh axis runs over.

    ``strict=True`` raises ``KeyError`` for an axis with no entry; the
    default warns once per axis name and falls back to ICI (NVLink), so a
    mispriced collective is never silent.
    """
    try:
        return AXIS_LINK[axis]
    except KeyError:
        if strict:
            raise KeyError(
                f"mesh axis {axis!r} has no AXIS_LINK entry; known axes: "
                f"{sorted(AXIS_LINK)} — register it so collectives on it "
                "are priced at the right link"
            ) from None
        warn_once(
            f"axis_link:{axis}",
            f"mesh axis {axis!r} has no AXIS_LINK entry; pricing its "
            "collectives at ICI bandwidth (add it to "
            "repro_torch.core.hardware.AXIS_LINK if it crosses another link)",
        )
        return Link.ICI


def axis_bandwidth(
    axis: str, system: SystemSpec | None = None, *, strict: bool = False
) -> float:
    """Per-card bandwidth available to a collective running on ``axis``."""
    system = system if system is not None else get_active_system()
    return system.link_bandwidth(link_for_axis(axis, strict=strict))
