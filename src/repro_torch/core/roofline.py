"""The three-term roofline of a step, from its counted work and the card.

Counterpart of ``repro/core/roofline.py``.  Per (architecture x shape)
step, from :class:`~repro_torch.core.op_analysis.StepCost` (the step run
once on ``meta``, :func:`~repro_torch.core.op_analysis.analyze_step`):

* ``compute_s``    = product FLOPs / peak bf16 FLOP/s;
* ``memory_s``     = the must-move bytes, ``model_bytes`` / HBM bandwidth;
* ``collective_s`` = collective wire bytes / link bandwidth: 0 on one
  card (the mesh is ROADMAP A10).

The terms are priced on the port's :class:`~repro_torch.core.hardware.
SystemSpec` — the H100 data sheet's 989 TFLOP/s bf16 and 3.35 TB/s, or
the active calibration.  The dominant term is the bottleneck;
``roofline_fraction`` scores compute-bound steps (useful model FLOPs over
what the card could do in the bound time) and ``bw_fraction`` movement-
bound ones (the must-move bytes, ``model_bytes``, over the bound time):
the paper's achieved/theoretical bound fraction, lifted to whole steps.

The counted bytes (``hlo_bytes``, and ``bytes_by_op`` in the count) are
per aten op and unfused over the plain versions, with every intermediate
they materialize (an upper count, see :mod:`~repro_torch.core.
op_analysis`): a diagnostic, not a bound.  So the port prices the memory
term on the floor, ``model_bytes`` (:func:`report_from_step` and the dry
run), and ``bound_step_s`` is the least time the card could take; the
reference's :func:`report_from_cost` prices XLA's fused count and keeps
that as its default.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Mapping

from repro_torch.core.hardware import Link, SystemSpec, get_active_system, link_for_axis
from repro_torch.core.op_analysis import StepCost, analyze_step

__all__ = ["RooflineReport", "report_from_cost", "report_from_step",
           "markdown_table", "save_reports", "load_reports"]


@dataclasses.dataclass
class RooflineReport:
    """The roofline record of one (arch x shape x mesh) cell."""

    arch: str
    shape: str
    mesh: str
    num_chips: int
    # three terms, seconds per step
    compute_s: float
    memory_s: float
    collective_s: float
    # provenance
    hlo_flops: float              # counted product FLOPs (per card)
    hlo_bytes: float              # counted bytes (per card)
    collective_bytes: float       # per-card wire bytes
    collective_by_link: dict[str, float]
    collective_by_axes: dict[str, float]
    model_flops: float            # analytic 6·N·D (global, per step)
    model_bytes: float            # bytes that MUST move per step (global)
    useful_ratio: float           # model_flops / (hlo_flops * num_chips)
    dominant: str
    bound_step_s: float           # max of the three terms
    roofline_fraction: float      # ideal compute time / bound_step_s
    bw_fraction: float            # ideal memory time / bound_step_s
    notes: str = ""

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "RooflineReport":
        return RooflineReport(**d)


def _dominant(compute_s: float, memory_s: float, collective_s: float) -> str:
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return max(terms, key=terms.get)


def report_from_cost(
    cost: StepCost,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    num_chips: int,
    model_flops: float,
    model_bytes: float = 0.0,
    system: SystemSpec | None = None,
    notes: str = "",
    memory_bytes: float | None = None,
) -> RooflineReport:
    """The roofline record of a counted step (the reference's function,
    term for term).  ``memory_bytes``: the bytes the memory term is priced
    on (default the counted ``cost.hbm_bytes``, the reference's)."""
    system = system if system is not None else get_active_system()
    chip = system.chip
    compute_s = cost.flops / chip.peak_bf16_flops
    memory_s = (cost.hbm_bytes if memory_bytes is None else memory_bytes) / chip.hbm_bandwidth

    by_link: dict[str, float] = {}
    by_axes: dict[str, float] = {}
    collective_s = 0.0
    for axes, nbytes in cost.wire_bytes_by_axis_group().items():
        link = Link.ICI
        for ax in axes:
            if link_for_axis(ax) == Link.DCN:
                link = Link.DCN
                break
        key = str(link)
        by_link[key] = by_link.get(key, 0.0) + nbytes
        name = "+".join(axes) or "replica"
        by_axes[name] = by_axes.get(name, 0.0) + nbytes
    for key, nbytes in by_link.items():
        collective_s += nbytes / system.link_bandwidth(Link(key))

    total_flops = cost.flops * num_chips
    useful = model_flops / total_flops if total_flops else 0.0
    bound = max(compute_s, memory_s, collective_s)
    ideal_s = model_flops / (num_chips * chip.peak_bf16_flops)
    frac = ideal_s / bound if bound > 0 else 0.0
    ideal_mem_s = model_bytes / (num_chips * chip.hbm_bandwidth)
    bw_frac = ideal_mem_s / bound if bound > 0 else 0.0

    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, num_chips=num_chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops=cost.flops, hlo_bytes=cost.hbm_bytes,
        collective_bytes=cost.collective_wire_bytes,
        collective_by_link=by_link, collective_by_axes=by_axes,
        model_flops=model_flops, model_bytes=model_bytes, useful_ratio=useful,
        dominant=_dominant(compute_s, memory_s, collective_s),
        bound_step_s=bound, roofline_fraction=frac, bw_fraction=bw_frac, notes=notes,
    )


def report_from_step(
    fn: Callable,
    *args,
    arch: str,
    shape: str,
    model_flops: float,
    model_bytes: float,
    system: SystemSpec | None = None,
    notes: str = "",
    **kwargs,
) -> tuple[RooflineReport, StepCost]:
    """The roofline record of ``fn(*args, **kwargs)`` counted on ``meta``
    (:func:`~repro_torch.core.op_analysis.analyze_step`) on one card: the
    counterpart of the reference's ``report_from_compiled``.  The memory
    term is priced on ``model_bytes``, the must-move floor; the counted
    bytes stay in ``hlo_bytes``.  Returns the report and the count."""
    cost = analyze_step(fn, *args, **kwargs)
    report = report_from_cost(cost, arch=arch, shape=shape, mesh_name="1", num_chips=1,
                              model_flops=model_flops, model_bytes=model_bytes,
                              system=system, notes=notes, memory_bytes=model_bytes)
    return report, cost


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------

_HDR = ("| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
        "| dominant | useful | roofline frac | what would move it |")
_SEP = "|---" * 10 + "|"


def markdown_table(reports: list[RooflineReport]) -> str:
    rows = [_HDR, _SEP]
    for r in reports:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} "
            f"| {r.compute_s*1e3:.2f} | {r.memory_s*1e3:.2f} "
            f"| {r.collective_s*1e3:.2f} | {r.dominant} "
            f"| {r.useful_ratio:.2f} | {r.roofline_fraction:.1%} "
            f"| {r.notes or '-'} |"
        )
    return "\n".join(rows)


def save_reports(reports: list[RooflineReport], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_json() for r in reports], f, indent=1)


def load_reports(path: str) -> list[RooflineReport]:
    with open(path) as f:
        return [RooflineReport.from_json(d) for d in json.load(f)]
