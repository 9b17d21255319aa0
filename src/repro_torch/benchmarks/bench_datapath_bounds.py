"""Paper Fig. 3 + Table II + Figs. 15-17: the bound matrices, the memory
kinds, and the generated placement-policy table, from the datapath model.

Counterpart of the reference's ``benchmarks/bench_datapath_bounds.py``:

* the read bound of every tier and the copy-bound matrix (the
  twice-traversed-link halving rule), with the spec-sheet value beside
  each row when a calibration is active (``run --calibration``);
* the Figs. 15-17 policy table: for gemma3-27b at 256 chips, the
  predicted step of every registered policy in the training and decode
  regimes, each term derived from the bounds, the pick marked, and the
  spec-sheet step beside it when a calibration is active;
* the memory kinds a benchmark places buffers in on this device, the
  registry, and the headline constants with their provenance.

The reference's measured peer/remote column (an in-place read over a
donor-sharded buffer and a double-buffered ``DonorStream`` sweep) needs
two or more devices and a donor mesh axis, which one card does not have:
it is not ported, and a skip row says so (ROADMAP A10c).
"""

from __future__ import annotations

import torch

from repro_torch.benchmarks.common import emit, kinds
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.datapath import copy_bound, read_bound
from repro_torch.core.hardware import SPEC_SYSTEM, MemoryTier, get_active_system
from repro_torch.core.placement import registered_policies
from repro_torch.core.planner import plan
from repro_torch.models.model_zoo import ModelSizing

TIERS = [t for t in MemoryTier if t != MemoryTier.VMEM]

POLICY_ARCH = "gemma3-27b"
POLICY_CHIPS = 256


def _calibrated() -> bool:
    """Is the active system different from the spec sheet?"""
    return get_active_system() is not SPEC_SYSTEM


def policy_table() -> list[tuple[str, float, str]]:
    """Figs. 15-17 analogue: predicted step time per policy per regime."""
    sizing = ModelSizing(get_config(POLICY_ARCH))
    # 256 chips as a (pod=2) x (data=16) x (model=8) mesh
    train = sizing.train_workload(
        SHAPES["train_4k"], num_chips=POLICY_CHIPS, data_axis_size=16,
        pod_axis_size=2,
    )
    decode = sizing.decode_workload(SHAPES["decode_32k"], num_chips=POLICY_CHIPS)
    rows = []
    for regime, prof in (("train", train), ("decode", decode)):
        best, preds = plan(prof)
        spec_preds = {}
        if _calibrated():
            _, sp = plan(prof, system=SPEC_SYSTEM)
            spec_preds = {p.policy: p for p in sp}
        for p in preds:
            tag = "+best" if p.policy == best.policy else (
                "" if p.fits else "+nofit"
            )
            spec = spec_preds.get(p.policy)
            extra = "" if spec is None else f"|spec_step={spec.step_s*1e6:.2f}us"
            rows.append((
                f"policy[{regime}|{p.policy}]",
                p.step_s * 1e6,
                f"limited_by={p.limiting}|hbm={p.hbm_bytes/2**30:.2f}GiB"
                f"{extra}{tag}",
            ))
    for row in rows:
        emit(*row)
    return rows


def main(device) -> None:
    cal = _calibrated()
    # Fig. 3 (left): read bounds per tier — spec + calibrated
    for t in TIERS:
        b = read_bound(t)
        extra = ""
        if cal:
            extra = f" spec={read_bound(t, SPEC_SYSTEM).bandwidth/1e9:.1f}GB/s"
        emit(f"bound_read[{t}]", b.latency * 1e6,
             f"{b.bandwidth/1e9:.1f}GB/s via {b.limiting_link}{extra}")
    # Fig. 3 (right): copy bound matrix (the twice-traversed-halves rule)
    for src in TIERS:
        for dst in TIERS:
            b = copy_bound(src, dst)
            extra = ""
            if cal:
                sb = copy_bound(src, dst, SPEC_SYSTEM)
                extra = f" spec={sb.bandwidth/1e9:.1f}GB/s"
            emit(f"bound_copy[{src}->{dst}]", b.latency * 1e6,
                 f"{b.bandwidth/1e9:.1f}GB/s via {b.limiting_link}{extra}")
    # Figs. 15-17: the generated per-policy step-time table
    policy_table()
    emit("peer_measured", 0.0,
         "skipped: one card, no donor axis (ROADMAP A10c)")
    # Table II analogue: where this device's benchmarks place buffers
    emit("memory_kinds", 0.0, "|".join(kinds(torch.device(device))))
    # the live registry: policies registered later appear automatically
    emit("policies", 0.0, "|".join(registered_policies()))
    # headline numbers used throughout, with their provenance
    system = get_active_system()
    c = system.chip
    prov = system.provenance_of
    emit("chip_peak_bf16", 0.0,
         f"{c.peak_bf16_flops/1e12:.0f}TFLOP/s [{prov('peak_bf16_flops')}]")
    emit("chip_hbm_bw", 0.0,
         f"{c.hbm_bandwidth/1e9:.0f}GB/s [{prov('hbm_bandwidth')}]")
    emit("chip_host_dram_cap", 0.0, f"{c.host_dram_capacity/2**30:.0f}GiB")
    emit("ici_link_bw", 0.0,
         f"{c.ici_link_bandwidth/1e9:.0f}GB/s [{prov('ici_link_bandwidth')}]")
    emit("dcn_bw", 0.0,
         f"{c.dcn_bandwidth/1e9:.0f}GB/s [{prov('dcn_bandwidth')}]")
