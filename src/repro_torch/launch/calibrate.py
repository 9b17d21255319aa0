"""Calibrate the hardware model on one device and gate on replay drift.

``python -m repro_torch.launch.calibrate --out build/calibration.json
--report build/replay_report.json --gate 0.5`` runs the calibration
sweeps (:func:`repro_torch.core.calibration.calibrate`) on the card (or
on the CPU with ``--device cpu``), writes the provenance-tagged
``calibration.json`` (the reference's layout) and the per-term replay
error report, prints the spec-vs-measured summary, the replay table and
each regime's planner pick under the spec sheet against its pick under
the calibrated constants, and exits 1 when any term's mean
predicted-vs-measured relative error exceeds the gate.

Counterpart of the reference's ``tools/calibrate.py``.  The gate is a *drift* gate:
replay predictions are made under the calibrated constants, so a large
error means the linear cost model no longer describes the machine (or
the sweep was too noisy to fit), not that the spec sheet was optimistic.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.calibration import calibrate
from repro_torch.core.hardware import SPEC_SYSTEM
from repro_torch.core.planner import plan, train_profile
from repro_torch.models.model_zoo import ModelSizing

#: yi-6b serving at the shape chip_smoke.py serves it (8 slots, 2048
#: positions, 256-token prefill chunks)
SERVE_ARCH, SERVE_SHAPE, SERVE_CHUNK = "yi-6b", ShapeSpec("serve", 2048, 8, "decode"), 256


def regimes() -> dict:
    """The planner profiles calibration is checked against: the
    reference's training profile (27 B params on 256 chips as 2 pods x
    16-way data), and yi-6b's decode step and prefill dispatch on one
    card."""
    serve = ModelSizing(get_config(SERVE_ARCH))
    return {
        "train": train_profile(
            name="calibration-reference",
            param_bytes=2 * 27e9, step_flops=6 * 27e9 * 4096,
            activation_bytes=8 * 2**30, num_chips=256,
            data_axis_size=16, pod_axis_size=2,
        ),
        "decode": serve.decode_workload(SERVE_SHAPE),
        "prefill": serve.prefill_workload(SERVE_SHAPE, chunk_tokens=SERVE_CHUNK),
    }


def planner_comparison(calibrated) -> dict:
    """Each regime's pick under the spec sheet and under ``calibrated``."""
    out = {}
    for regime, prof in regimes().items():
        row = {}
        for name, system in (("spec", SPEC_SYSTEM), ("calibrated", calibrated)):
            best, _ = plan(prof, system=system)
            row[name] = {"pick": best.policy, "step_s": best.step_s,
                         "limiting": best.limiting}
        out[regime] = row
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/calibration.json", metavar="PATH",
                    help="where to write the calibration")
    ap.add_argument("--report", default="build/replay_report.json",
                    metavar="PATH", help="where to write the replay error report")
    ap.add_argument("--gate", type=float, default=None, metavar="REL_ERR",
                    help="fail (exit 1) when any term's mean relative error "
                         "exceeds this (e.g. 0.5 = 50%%)")
    ap.add_argument("--gate-term", action="append", default=[],
                    metavar="TERM=REL_ERR",
                    help="per-term gate override, repeatable "
                         "(e.g. --gate-term hbm_bandwidth=0.25)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--sizes", default=None,
                    help="comma-separated sweep sizes in bytes (default: "
                         "256 MiB-1 GiB on the card, 256 KiB-16 MiB on the CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    kwargs = {"repeats": args.repeats, "device": args.device}
    if args.sizes:
        kwargs["sizes"] = tuple(int(s) for s in args.sizes.split(","))
    cal = calibrate(**kwargs)
    for path in (args.out, args.report):
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    cal.save(args.out)
    print(cal.summary())
    print()
    print(cal.replay.report())

    # spec-vs-calibrated planner picks: does calibration move a decision?
    comparison = planner_comparison(cal.apply())
    print()
    for regime, row in comparison.items():
        for name, r in row.items():
            print(f"planner[{regime}|{name}] pick={r['pick']} "
                  f"step={r['step_s']*1e6:.2f}us limited_by={r['limiting']}")

    report = {
        "per_term": {
            t: e.to_json() for t, e in cal.replay.per_term_error().items()
        },
        "gate": args.gate,
        "planner_comparison": comparison,
    }
    pathlib.Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
    print(f"\nwrote {args.out} and {args.report}")

    if args.gate is not None:
        per_term = {}
        for spec in args.gate_term:
            term, _, value = spec.partition("=")
            per_term[term] = float(value)
        violations = cal.replay.gate(args.gate, per_term)
        if violations:
            print("\nDRIFT GATE FAILED:")
            for v in violations:
                print(f"  {v}")
            return 1
        print(f"\ndrift gate OK (mean rel error <= {args.gate:.0%} per term)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
