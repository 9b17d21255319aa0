"""Calibrate the hardware model from the port's own microbenchmarks.

Counterpart of ``repro/core/calibration.py``; ``calibration.json`` has the
reference's layout (``FORMAT_VERSION`` 1), so either package loads the
other's.  The paper's method is to *measure* every datapath and report
the achieved fraction of its bound; this module closes the loop by
rewriting the constants themselves from those measurements.

On one card ``calibrate()`` runs ``bench_membw``'s read kernel
(``csrc/membench.cu``) over device memory and over pinned host memory
read in place, fits ``t = latency + nbytes / bandwidth`` per link
(:func:`repro_torch.core.membench.linear_fit`) into ``hbm_bandwidth`` /
``hbm_latency`` and ``pcie_bandwidth`` / ``pcie_latency``, and derives a
:class:`repro_torch.core.hardware.SystemSpec` whose terms carry
``measured`` provenance.  The NVLink (``ici_*``) and InfiniBand
(``dcn_*``) terms need more than one card and keep ``spec`` provenance;
the summary says so.  On the CPU only the "HBM" term (host DRAM, read by
``torch.sum``) is measured, as in the reference.

The result is a :class:`Calibration`: per-term spec-vs-measured values
plus a :class:`repro_torch.core.replay.ReplayLog` that replays every sweep
point against the *calibrated* bounds, whose per-term relative error
drives the drift gate (:meth:`ReplayLog.gate`).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Mapping, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.datapath import read_bound
from repro_torch.core.hardware import (
    CALIBRATED_TERMS,
    MemoryTier,
    SystemSpec,
    get_active_system,
    set_active_system,
)
from repro_torch.core.membench import Measurement, linear_fit, measure
from repro_torch.core.replay import ReplayLog
from repro_torch.kernels import ops

__all__ = [
    "TermCalibration",
    "Calibration",
    "calibrate",
    "load_or_calibrate",
    "host_available",
]

#: the reference's buffer-size sweep (bytes), used on the CPU: small enough
#: for CI, spread enough for the latency/bandwidth fit to separate its terms
DEFAULT_SIZES: tuple[int, ...] = (2**18, 2**21, 2**24)

#: the card's sweep: every size past the H100's 50 MB L2, so the device
#: read measures HBM and not L2 (256 MiB, 512 MiB, 1 GiB)
CUDA_SIZES: tuple[int, ...] = (2**28, 2**29, 2**30)

FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TermCalibration:
    """One constant's spec-vs-measured record."""

    term: str
    spec: float
    measured: float
    unit: str                 # "B/s" | "s"
    source: str               # which kernel produced it
    detail: str = ""          # free-form: fit quality, device count, ...

    @property
    def ratio(self) -> float:
        """measured / spec — how far the machine is from the sheet."""
        return self.measured / self.spec if self.spec else float("inf")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Mapping) -> "TermCalibration":
        return cls(**{f.name: obj[f.name] for f in dataclasses.fields(cls)
                      if f.name in obj})


@dataclasses.dataclass
class Calibration:
    """A full calibration run: measured terms + replay validation."""

    backend: str
    num_devices: int
    created: str                                   # ISO timestamp
    terms: dict[str, TermCalibration] = dataclasses.field(
        default_factory=dict
    )
    replay: ReplayLog = dataclasses.field(default_factory=ReplayLog)

    def apply(self, system: SystemSpec | None = None) -> SystemSpec:
        """Derive a system with every measured term rewritten (provenance
        ``measured``)."""
        system = system if system is not None else get_active_system()
        if not self.terms:
            return system
        return system.with_measurements(
            **{t: c.measured for t, c in self.terms.items()}
        )

    def summary(self) -> str:
        lines = [
            f"calibration: backend={self.backend} devices={self.num_devices}"
            f" created={self.created}",
            f"{'term':<22} {'spec':>12} {'measured':>12} {'ratio':>7} "
            f"source",
        ]
        for term in sorted(self.terms):
            c = self.terms[term]
            lines.append(
                f"{term:<22} {_si(c.spec, c.unit):>12} "
                f"{_si(c.measured, c.unit):>12} {c.ratio:>6.2f}x {c.source}"
            )
        uncal = sorted(set(CALIBRATED_TERMS) - set(self.terms))
        if uncal:
            lines.append(f"(spec provenance kept for: {', '.join(uncal)})")
        return "\n".join(lines)

    # -- persistence ------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "backend": self.backend,
            "num_devices": self.num_devices,
            "created": self.created,
            "terms": {t: c.to_json() for t, c in sorted(self.terms.items())},
            "provenance": {t: "measured" for t in sorted(self.terms)},
            "replay": self.replay.to_json(),
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> "Calibration":
        version = obj.get("format_version", 0)
        if version > FORMAT_VERSION:
            raise ValueError(
                f"calibration.json format {version} is newer than this "
                f"code understands ({FORMAT_VERSION}); re-run calibrate()"
            )
        return cls(
            backend=obj.get("backend", "unknown"),
            num_devices=int(obj.get("num_devices", 0)),
            created=obj.get("created", ""),
            terms={
                t: TermCalibration.from_json(c)
                for t, c in obj.get("terms", {}).items()
            },
            replay=ReplayLog.from_json(obj.get("replay", {})),
        )

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Calibration":
        return cls.from_json(json.loads(pathlib.Path(path).read_text()))


def _si(v: float, unit: str) -> str:
    if unit == "B/s":
        return f"{v / 1e9:.2f}GB/s"
    if unit == "s":
        return f"{v * 1e6:.2f}us"
    return f"{v:.3g}{unit}"


# ---------------------------------------------------------------------------
# Measurement kernel (in-process bench_membw read sweep)
# ---------------------------------------------------------------------------

def host_available(device: str | torch.device | None = None) -> bool:
    """Is there a host tier distinct from the device's memory?  True on
    ``cuda`` (pinned host memory behind PCIe), false on ``cpu``."""
    return resolve_device(device).type == "cuda"


def _sweep_read(kind: str | None, sizes: Sequence[int], repeats: int,
                device: torch.device) -> list[Measurement]:
    """bench_membw's read kernel over a float32 buffer of each size, in
    the device's own memory (``None``) or in ``pinned_host`` memory the
    card reads in place."""
    out = []
    label = kind or "device"
    for nbytes in sizes:
        if kind is None:
            x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
        else:
            x = torch.ones(nbytes // 4, dtype=torch.float32).pin_memory()
        out.append(measure(
            lambda x=x: ops.stream_read(x, device=device),
            name=f"read[{label},{nbytes}]", nbytes=nbytes, repeats=repeats,
            device=device,
        ))
        del x
    return out


# ---------------------------------------------------------------------------
# calibrate(): run kernels -> fit terms -> replay against calibrated bounds
# ---------------------------------------------------------------------------

def calibrate(
    system: SystemSpec | None = None,
    *,
    sizes: Sequence[int] | None = None,
    repeats: int = 5,
    device: str | torch.device | None = None,
) -> Calibration:
    """Measure every link one ``device`` reaches and build a
    :class:`Calibration` (``device`` defaults to ``cuda``).

    ``sizes`` defaults to :data:`CUDA_SIZES` on the card (all past L2) and
    :data:`DEFAULT_SIZES` on the CPU.  PCIe terms need a host tier
    (:func:`host_available`); ICI and DCN terms need more than one card
    and keep ``spec`` provenance, as unreachable terms do in the
    reference.
    """
    system = system if system is not None else get_active_system()
    dev = resolve_device(device)
    if sizes is None:
        sizes = CUDA_SIZES if dev.type == "cuda" else DEFAULT_SIZES
    cal = Calibration(
        backend=dev.type,
        num_devices=1,
        created=time.strftime("%Y-%m-%dT%H:%M:%S"),
    )
    sweeps: dict[str, list[Measurement]] = {}

    def fit(term_bw: str, term_lat: str, source: str,
            ms: list[Measurement], detail: str) -> None:
        latency, bandwidth = linear_fit(ms)
        spec_bw = system.term_value(term_bw)
        spec_lat = system.term_value(term_lat)
        cal.terms[term_bw] = TermCalibration(
            term=term_bw, spec=spec_bw, measured=bandwidth,
            unit="B/s", source=source, detail=detail,
        )
        # a fit intercept of ~0 (bulk-dominated sweep) would erase the
        # latency term entirely; keep spec latency unless the fit
        # resolved something above the timer floor.
        if latency > 1e-7:
            cal.terms[term_lat] = TermCalibration(
                term=term_lat, spec=spec_lat, measured=latency,
                unit="s", source=source, detail=detail,
            )

    # 1. HBM bus: device-memory read sweep (host DRAM on the CPU)
    ms = _sweep_read(None, sizes, repeats, dev)
    sweeps["hbm_bandwidth"] = ms
    fit("hbm_bandwidth", "hbm_latency", "bench_membw.read[device]", ms,
        f"sizes={list(sizes)}")

    # 2. PCIe: pinned-host read sweep, read in place by the card
    if host_available(dev):
        ms = _sweep_read("pinned_host", sizes, repeats, dev)
        sweeps["pcie_bandwidth"] = ms
        fit("pcie_bandwidth", "pcie_latency",
            "bench_membw.read[pinned_host]", ms, f"sizes={list(sizes)}")

    calibrated = cal.apply(system)

    # Replay: every sweep point predicted under the *calibrated* bounds.
    bound_of = {
        "hbm_bandwidth": read_bound(MemoryTier.HBM, calibrated),
        "pcie_bandwidth": read_bound(MemoryTier.HOST, calibrated),
    }
    for term, ms in sweeps.items():
        b = bound_of[term]
        for m in ms:
            cal.replay.record(
                term, m.name, b.time(m.nbytes), m.mean_s,
                nbytes=int(m.nbytes), limiting_link=str(b.limiting_link),
                source="calibrate",
            )
    return cal


def load_or_calibrate(
    path: str | pathlib.Path | None,
    *,
    activate: bool = False,
    system: SystemSpec | None = None,
    **kwargs,
) -> Calibration:
    """Load ``calibration.json`` if it exists, else calibrate and save.

    ``path=None`` always calibrates (nothing persisted).  With
    ``activate=True`` the calibrated system is installed process-wide via
    :func:`repro_torch.core.hardware.set_active_system`.
    """
    if path is not None and pathlib.Path(path).exists():
        cal = Calibration.load(path)
    else:
        cal = calibrate(system, **kwargs)
        if path is not None:
            cal.save(path)
    if activate:
        set_active_system(cal.apply(system))
    return cal
