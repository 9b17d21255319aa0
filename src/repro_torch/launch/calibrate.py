"""Calibrate the hardware model on one device and gate on replay drift.

``python -m repro_torch.launch.calibrate --out build/calibration.json
--report build/replay_report.json --gate 0.5`` runs the calibration
sweeps (:func:`repro_torch.core.calibration.calibrate`) on the card (or
on the CPU with ``--device cpu``), writes the provenance-tagged
``calibration.json`` (the reference's layout) and the per-term replay
error report, prints the spec-vs-measured summary and the replay table,
and exits 1 when any term's mean predicted-vs-measured relative error
exceeds the gate.

Counterpart of the reference's ``tools/calibrate.py`` without its planner
comparison: the planner is not ported yet.  The gate is a *drift* gate:
replay predictions are made under the calibrated constants, so a large
error means the linear cost model no longer describes the machine (or
the sweep was too noisy to fit), not that the spec sheet was optimistic.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.core.calibration import calibrate


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

    report = {
        "per_term": {
            t: e.to_json() for t, e in cal.replay.per_term_error().items()
        },
        "gate": args.gate,
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
