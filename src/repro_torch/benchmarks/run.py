"""Benchmark harness: one module per paper table/figure, on one device.

``python -m repro_torch.benchmarks.run [--only NAME] [--device cpu]
[--calibration PATH]`` — each module prints ``name,us_per_call,derived``
CSV rows.  Counterpart of the reference's ``benchmarks/run.py``, for the
modules one card measures:

  bench_membw             Figs. 2, 7, 8
  bench_copy              Figs. 5, 9, 10
  bench_latency           Figs. 11, 12
  bench_gemm              Figs. 15, 16 + Table III
  bench_managed_vs_system Fig. 4
  bench_datapath_bounds   Fig. 3, Table II, Figs. 15-17 (the policy table)
  bench_llm_inference     Fig. 17 (serve, queued and analytic legs)
  bench_pingpong          Fig. 13 (gloo ranks on the CPU + the NVLink/IB ladder)
  bench_internode         Fig. 14 (gloo ranks on the CPU + alpha-beta rows)
  bench_collectives       Figs. 18, 19 (gloo ranks on the CPU + algo-bw rows)

The device defaults to ``cuda``; without a card that raises.  The last
three measure over gloo ranks on the CPU whatever the device (NCCL
between cards needs several; each prints a skip row saying so).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

from repro_torch import resolve_device

MODULES = [
    "bench_membw",
    "bench_copy",
    "bench_latency",
    "bench_gemm",
    "bench_managed_vs_system",
    "bench_datapath_bounds",
    "bench_llm_inference",
    "bench_pingpong",
    "bench_internode",
    "bench_collectives",
]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, choices=MODULES,
                    help="run a single module")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument(
        "--calibration", default=None, metavar="PATH",
        help="activate a measurement-calibrated hardware model from this "
             "calibration.json (written by repro_torch.launch.calibrate) so "
             "every analytic row prices with the measured terms",
    )
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.calibration is not None:
        from repro_torch.core.calibration import Calibration
        from repro_torch.core.hardware import set_active_system

        cal = Calibration.load(args.calibration)
        set_active_system(cal.apply())
        print(f"# calibration: {args.calibration} (backend={cal.backend}, "
              f"{len(cal.terms)} measured terms)")

    failures = 0
    for name in [args.only] if args.only else MODULES:
        print(f"# ==== {name} ====")
        t0 = time.time()
        try:
            importlib.import_module(f"repro_torch.benchmarks.{name}").main(dev)
        except Exception:
            failures += 1
            traceback.print_exc()
            print(f"{name},0.00,FAILED")
        print(f"# {name} done in {time.time()-t0:.1f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
