"""The dry-run and roofline tables from the port's dry-run JSON.

Counterpart of the reference's ``tools/render_experiments.py``::

    PYTHONPATH=src python -m repro_torch.tools.render_experiments build/dryrun.json

The input is what ``python -m repro_torch.launch.dryrun --out`` writes:
one record per (arch x shape) cell, counted on ``meta`` on one card.
"""

from __future__ import annotations

import json
import sys


def render(recs: list[dict]) -> str:
    """The markdown tables of the records."""
    out = ["### Dry-run summary (per cell, one card)\n",
           "| arch | shape | mesh | status | count (s) | args (GiB) "
           "| peak (GiB, estimate) | fits one card | flops | notes |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            why = r.get("reason") or r.get("error", "")
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                       f"| - | - | - | - | - | {why} |")
            continue
        ma = r["memory_analysis"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
            f"| {r['compile_s']:.1f} "
            f"| {ma['argument_bytes_per_device'] / 2**30:.2f} "
            f"| {ma['peak_bytes_per_device'] / 2**30:.2f} "
            f"| {'yes' if ma['fits_one_card'] else 'no'} "
            f"| {r['cost_analysis']['xla_flops_per_device']:.3g} | |")

    out += ["\n### Roofline (one H100, the spec sheet's or the active calibration's "
            "terms; bytes per aten op, unfused: an upper count)\n",
            "| arch | shape | compute (ms) | memory (ms) | collective (ms) "
            "| dominant | useful | frac | bw-frac | must-move (GB) |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rl['compute_s'] * 1e3:.1f} | {rl['memory_s'] * 1e3:.1f} "
            f"| {rl['collective_s'] * 1e3:.1f} | {rl['dominant']} "
            f"| {rl['useful_ratio']:.2f} | {rl['roofline_fraction']:.1%} "
            f"| {rl['bw_fraction']:.1%} | {rl['model_bytes'] / 1e9:.1f} |")
    out.append("\nNo multi-pod table: the port's dry run has no mesh yet (ROADMAP A10).")
    return "\n".join(out)


def main(path: str = "build/dryrun.json") -> None:
    with open(path) as f:
        print(render(json.load(f)))


if __name__ == "__main__":
    main(*sys.argv[1:2])
