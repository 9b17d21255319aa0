"""Placement sweep on one card: the paper's §IV study as a decision procedure.

    python -m repro_torch.examples.placement_sweep [--arch olmo-1b] [--analytic]
        [--calibration build/calibration.json] [--device cpu]

Counterpart of the reference's ``examples/placement_sweep.py``, in two
parts:

1. **Predicted** (the Figs. 15-17 table): for the full-size architecture
   at ``--chips`` chips, the planner's step time and memory-pool fit for
   every registered policy, in the training (``train_4k``) and decoding
   (``decode_32k``) regimes, and the policy it picks; then the RESIDENT
   host spellings :data:`RESIDENT_SPELLINGS`, which the registry does not
   hold (the pick is over the registry, as the reference's).
2. **Predicted vs measured** (skipped by ``--analytic``): one decode step
   of ``--arch`` measured under each policy the device realizes, through
   the serving engine (its CUDA graphs on a card), next to the planner's
   price of that step on the spec sheet and, with ``--calibration``, on
   the calibration; then measured over priced.  Every row reads a full
   cache (each slot at ``max_len - 1``), as the planner prices it.  A card
   measures the full-size config at ``--slots`` x ``--max-len`` (default
   8 x 2048, the serving shape); the CPU its smoke config at 2 x 64.  Peer
   and remote rows are starred: they need a donor mesh axis one device
   does not have, and only their prices are shown.

``--calibration PATH`` prices every prediction on a calibration.json (from
``python -m repro_torch.launch.calibrate``); the spec sheet's price stays
beside it.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, ShapeSpec, get_config, smoke_config
from repro_torch.core.hardware import SPEC_SYSTEM, get_active_system
from repro_torch.core.placement import (
    DonorAxisError,
    parse_policy,
    registered_policies,
    validate_policy_for_mesh,
)
from repro_torch.core.planner import plan, predict
from repro_torch.models.model_zoo import ModelBundle, ModelSizing

#: host placements a step computes on in place (no ``:stream``), priced
#: and measured beside the registry
RESIDENT_SPELLINGS = ("kv=host", "params=host", "opt=host")


def _calibrated() -> bool:
    return get_active_system() is not SPEC_SYSTEM


def _mesh_axes(chips: int, data_axis: int, pod_axis: int) -> tuple[int, int]:
    """Clamp the requested axis sizes to what ``chips`` can host."""
    if data_axis * pod_axis > chips:
        pod_axis = 1
        data_axis = min(data_axis, chips)
    return data_axis, pod_axis


def resident_policies():
    """:data:`RESIDENT_SPELLINGS` as policies named by their spelling."""
    return [parse_policy(s).renamed(s) for s in RESIDENT_SPELLINGS]


def predicted_tables(arch: str, chips: int, data_axis: int, pod_axis: int) -> None:
    """Print the train and decode tables under the active system."""
    sizing = ModelSizing(get_config(arch))
    cfg = sizing.cfg
    data_axis, pod_axis = _mesh_axes(chips, data_axis, pod_axis)
    print(f"=== {cfg.name}: {cfg.num_params()/1e9:.1f}B params, "
          f"{chips} chips (data axis {data_axis}, pod axis {pod_axis}) ===\n")

    def table(prof):
        best, preds = plan(prof)
        spec = {}
        if _calibrated():
            spec = {p.policy: p for p in plan(prof, system=SPEC_SYSTEM)[1]}
        extra = [predict(prof, pol) for pol in resident_policies()]
        if _calibrated():
            spec.update({p.policy: predict(prof, pol, SPEC_SYSTEM)
                         for p, pol in zip(extra, resident_policies())})
        for p in preds + extra:
            mark = " <== planner pick" if p.policy == best.policy else ""
            note = (f" [spec: {spec[p.policy].step_s*1e3:.3f}ms]"
                    if p.policy in spec else "")
            print("  " + p.explain() + note + mark)

    print("-- training (train_4k) --")
    table(sizing.train_workload(SHAPES["train_4k"], num_chips=chips,
                                data_axis_size=data_axis, pod_axis_size=pod_axis))
    print("\n-- decoding (decode_32k) --")
    table(sizing.decode_workload(SHAPES["decode_32k"], num_chips=chips))


def measure_decode_ms(bundle, policy, device, slots: int, max_len: int,
                      iters: int) -> float | None:
    """The decode step's wall-time EWMA (``Runtime.measured_step_s``) over
    ``iters`` steps of a fresh engine under ``policy`` with every slot at
    ``max_len - 1``; None when one device cannot realize the policy."""
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.engine import Executor

    try:
        validate_policy_for_mesh(policy, None)
    except DonorAxisError:
        return None
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    cfg = ServeConfig(batch_slots=slots, max_len=max_len, prefill_chunk=min(256, max_len),
                      policy=policy)
    eng = Executor(bundle, cfg, params, device)
    del params
    eng.state["lengths"].fill_(max_len - 1)
    for _ in range(iters + 1):
        eng.decode()
    return eng.measured_step_s * 1e3


def predicted_vs_measured(arch: str, device, slots: int, max_len: int, iters: int) -> None:
    cfg = get_config(arch) if device.type == "cuda" else smoke_config(arch)
    bundle = ModelBundle(cfg)
    prof = bundle.decode_workload(ShapeSpec("local", max_len, slots, "decode"))
    cal = _calibrated()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(f"\n=== predicted vs measured: {cfg.name} decode on {name} ({slots} slots x "
          f"{max_len} ctx, calibration={'active' if cal else 'none (spec sheet)'}) ===")
    print(f"{'policy':<28} {'fits':<5} {'pred spec ms':>12} {'pred cal ms':>12} "
          f"{'measured ms':>12} {'meas/spec':>10} {'meas/cal':>9}")
    starred = False
    for policy in list(registered_policies().values()) + resident_policies():
        pred = predict(prof, policy)
        spec = predict(prof, policy, SPEC_SYSTEM)
        cal_ms = f"{pred.step_s*1e3:>12.4f}" if cal else f"{'-':>12}"
        t0 = time.perf_counter()
        meas = measure_decode_ms(bundle, policy, device, slots, max_len, iters)
        if meas is None:
            starred = True
            print(f"{policy.name + '*':<28} {str(spec.fits):<5} {spec.step_s*1e3:>12.4f} "
                  f"{cal_ms} {'-':>12} {'-':>10} {'-':>9}")
            continue
        ratio_cal = f"{meas / (pred.step_s*1e3):>9.2f}" if cal else f"{'-':>9}"
        print(f"{policy.name:<28} {str(spec.fits):<5} {spec.step_s*1e3:>12.4f} {cal_ms} "
              f"{meas:>12.4f} {meas / (spec.step_s*1e3):>10.2f} {ratio_cal}"
              f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if starred:
        print("* not measurable here: needs a donor mesh axis (more than one device)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--data-axis", type=int, default=16,
                    help="data-parallel (ICI) axis size for the train table")
    ap.add_argument("--pod-axis", type=int, default=2,
                    help="pod (DCN) axis size for the train table")
    ap.add_argument("--slots", type=int, default=None, help="8 on a card, 2 on the CPU")
    ap.add_argument("--max-len", type=int, default=None,
                    help="2048 on a card, 64 on the CPU")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--no-measure", "--analytic", dest="no_measure", action="store_true",
                    help="predicted tables only (pure analysis)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="price on this calibration.json (launch/calibrate.py)")
    args = ap.parse_args(argv)

    if args.calibration:
        from repro_torch.core.calibration import Calibration
        from repro_torch.core.hardware import set_active_system

        set_active_system(Calibration.load(args.calibration).apply(SPEC_SYSTEM))
        print(f"(calibration active: {args.calibration})\n")
    predicted_tables(args.arch, args.chips, args.data_axis, args.pod_axis)
    if not args.no_measure:
        device = resolve_device(args.device)
        card = device.type == "cuda"
        predicted_vs_measured(args.arch, device, args.slots or (8 if card else 2),
                              args.max_len or (2048 if card else 64), args.iters)


if __name__ == "__main__":
    main()
