"""One-card dry run: count every (arch x shape) step on ``meta``.

Counterpart of ``repro/launch/dryrun.py:80-340``.  The reference lowers
and compiles each cell on a production mesh from ``ShapeDtypeStruct``
stand-ins and reads the compiled module.  Here, for each cell:

1. every input of the step — params, optimizer state and batch for
   ``train``; params, batch and caches for the serving modes — is a
   ``meta`` tensor built from the bundle's defs (not ``init_params``: the
   counterpart of ``ShapeDtypeStruct``), so nothing is allocated;
2. the step runs once under :func:`~repro_torch.core.op_analysis.
   analyze_step`: ``make_train_step`` for ``train``, ``bundle.prefill`` /
   ``bundle.decode_step`` for the other modes, on the plain versions (a
   ``meta`` tensor takes the plain path of :mod:`repro_torch.kernels.ops`);
   a shape or dtype mismatch, or a data-dependent op, fails here;
3. the record keeps the reference's keys.  ``mesh`` is ``"1"`` (one card;
   the meshes are ROADMAP A10).  ``lower_s`` is the inputs' and the step's
   construction, ``compile_s`` the counting run.  ``memory_analysis``
   holds the argument and output bytes and the peak of live bytes the
   counting run tracked, an estimate (it follows the plain versions),
   with ``fits_one_card``: that peak against the card's 80 GB.
   ``cost_analysis`` and ``roofline`` hold the
   :class:`~repro_torch.core.op_analysis.StepCost` and the
   :class:`~repro_torch.core.roofline.RooflineReport`.  The counted bytes
   are per aten op and unfused, an upper count kept as a diagnostic; the
   roofline's memory term is priced on ``model_bytes``, the must-move
   floor.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out build/dryrun.json

``--multipod-only``, ``--singlepod-only`` and ``--optimized`` (whose
cells are mesh rules) need the meshes and exit naming ROADMAP A10.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (
    SHAPES,
    ShapeSpec,
    get_config,
    list_archs,
    shape_applicable,
    smoke_config,
)
from repro_torch.core.hardware import get_active_system
from repro_torch.core.op_analysis import analyze_step
from repro_torch.core.roofline import report_from_cost
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import torch_dtype, tree_map
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step

__all__ = ["input_specs", "lower_cell", "main"]

#: the one card's "mesh"
MESH = "1"


def defs_to_meta(defs, dtype):
    """Param-def pytree -> ``meta`` tensors of its shapes and dtypes."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=torch_dtype(p.dtype or dtype),
                                          device="meta"), defs)


def _shape(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def input_specs(arch: str, shape="train_4k", *, smoke: bool = False):
    """``meta`` stand-ins for every input of this cell.

    Returns ``(bundle, inputs)`` where ``inputs`` carries ``batch`` and
    ``params`` plus, per mode, ``opt_state`` and ``ef`` (train) or
    ``caches`` (serve).  ``smoke`` takes the arch's smoke config."""
    bundle = ModelBundle(smoke_config(arch) if smoke else get_config(arch))
    shape = _shape(shape)
    dtype = bundle.cfg.dtype
    params = defs_to_meta(bundle.param_defs(), dtype)
    out = {"batch": defs_to_meta(bundle.input_defs(shape), dtype), "params": params,
           "mode": shape.mode}
    if shape.mode == "train":
        out["opt_state"] = init_opt_state(params)
        out["ef"] = tree_map(lambda _: torch.empty((), dtype=torch.float32, device="meta"),
                             params)
    else:
        out["caches"] = defs_to_meta(
            bundle.cache_defs(shape.global_batch, bundle.decode_cache_len(shape)), dtype)
    return bundle, out


def lower_cell(arch: str, shape="train_4k", *, smoke: bool = False,
               remat: str = "full", n_micro: int | None = None,
               verbose: bool = True):
    """Count one cell on ``meta``.  Returns ``(record, cost)``.

    ``shape`` is a name in ``SHAPES`` or a :class:`ShapeSpec`.  Training
    takes the reference's gradient accumulation (4 microbatches from
    ``d_model >= 5000``) and ``remat``."""
    shape = _shape(shape)
    t0 = time.perf_counter()
    bundle, specs = input_specs(arch, shape, smoke=smoke)
    if shape.mode == "train":
        if n_micro is None:
            n_micro = 4 if bundle.cfg.d_model >= 5000 else 1
        step = make_train_step(bundle, TrainConfig(remat=remat, n_microbatches=n_micro))
        args = (specs["params"], specs["opt_state"], specs["ef"], specs["batch"])
    else:
        fn = bundle.prefill if shape.mode == "prefill" else bundle.decode_step

        def step(params, batch, caches, _fn=fn):
            with torch.no_grad():
                return _fn(params, batch, caches)
        args = (specs["params"], specs["batch"], specs["caches"])
    t_lower = time.perf_counter() - t0

    t0 = time.perf_counter()
    cost = analyze_step(step, *args)
    t_count = time.perf_counter() - t0

    floor = bundle.model_bytes(shape)
    report = report_from_cost(
        cost, arch=arch, shape=shape.name, mesh_name=MESH, num_chips=1,
        model_flops=bundle.model_flops(shape), model_bytes=floor, memory_bytes=floor,
    )
    capacity = get_active_system().chip.hbm_capacity
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": MESH,
        "status": "ok",
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_count, 2),
        "memory_analysis": {
            "argument_bytes_per_device": cost.argument_bytes,
            "output_bytes_per_device": cost.output_bytes,
            "temp_bytes_per_device": max(cost.peak_bytes - cost.argument_bytes, 0.0),
            "alias_bytes_per_device": cost.alias_bytes,
            "peak_bytes_per_device": cost.peak_bytes,
            "peak_is_estimate": True,
            "fits_one_card": cost.peak_bytes <= capacity,
        },
        "cost_analysis": {
            "xla_flops_per_device": cost.flops,
            "xla_bytes_per_device": cost.hbm_bytes,
            "step_cost": cost.to_json(),
        },
        "roofline": report.to_json(),
        "collectives": [],
    }
    if verbose:
        ma = record["memory_analysis"]
        print(f"[{arch} × {shape.name} × {MESH}] counted in {t_count:.1f}s | peak "
              f"{ma['peak_bytes_per_device'] / 2**30:.2f} GiB (estimate; "
              f"{'fits' if ma['fits_one_card'] else 'does not fit'} one card) | flops "
              f"{cost.flops:.3g} | bytes {cost.hbm_bytes:.3g} | {cost.instruction_count:.0f} "
              f"ops | dominant {report.dominant} | frac {report.roofline_fraction:.1%} | "
              f"bw-frac {report.bw_fraction:.1%}")
    return record, cost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (the default when --arch is not given)")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--singlepod-only", action="store_true")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--out", default="build/dryrun.json")
    args = ap.parse_args(argv)
    asked = [f for f in ("multipod_only", "singlepod_only", "optimized") if getattr(args, f)]
    if asked:
        raise SystemExit(
            f"--{asked[0].replace('_', '-')}: the dry run's meshes (single- and multi-pod, "
            "and the optimized cells' mesh rules) are not ported yet (ROADMAP A10); the "
            "port's dry run counts each cell on one card")

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    records, failures = [], 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            ok, why = shape_applicable(arch, shape_name)
            if not ok:
                records.append({"arch": arch, "shape": shape_name, "mesh": MESH,
                                "status": "skipped", "reason": why})
                print(f"[{arch} × {shape_name}] SKIP: {why}")
                continue
            try:
                rec, _ = lower_cell(arch, shape_name)
                records.append(rec)
            except Exception as e:
                failures += 1
                traceback.print_exc()
                records.append({"arch": arch, "shape": shape_name, "mesh": MESH,
                                "status": "failed", "error": f"{type(e).__name__}: {e}"})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    print(f"\n{n_ok} ok, {n_skip} skipped, {failures} failed -> {args.out} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
