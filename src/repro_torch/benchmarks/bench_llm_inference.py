"""Paper Fig. 17: LLM decode throughput against physical memory placement.

Counterpart of the reference's ``benchmarks/bench_llm_inference.py``, two
of its four legs:

* **serve** — the continuous-batching server end to end (compiled steps:
  CUDA graphs on the card), prefill and decode tokens/s reported
  separately for prefill chunks of 8 and 32, the reference's requests,
  slots and ``max_len``.  Each entry embeds the serving policy's JSON and
  the planner's pick and top-3 table for the decode and prefill profiles
  of that shape, so the artifact names the placement behind its numbers.
  Written to ``build/BENCH_serve.json``.
* **analytic** — the planner's per-policy decode-step prediction for the
  full yi-6b / gemma3-27b / deepseek-v2-236b configs at ``decode_32k`` on
  256 chips: the paper's figure as a table, priced on the active
  ``SystemSpec``.

Not ported: the **measured** leg (decode under ``hbm_resident``,
``kv_host`` and ``weights_stream`` placements) needs realized host tiers
(ROADMAP A9, second half); the **queued** leg needs preemption (A11).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.core.placement import (
    donor_allow_flags,
    get_policy,
    registered_policies,
)
from repro_torch.core.planner import PolicyPrediction, decode_profile, plan, predict
from repro_torch.models.model_zoo import ModelSizing, get_smoke_bundle

#: where the serve leg writes its artifact
OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "BENCH_serve.json"

ANALYTIC_ARCHS = ("yi-6b", "gemma3-27b", "deepseek-v2-236b")
ANALYTIC_CHIPS = 256


def analytic() -> list[tuple[str, float, str]]:
    """Predicted decode step per registered policy (the reference's rows)."""
    shape = SHAPES["decode_32k"]
    rows = []
    for arch in ANALYTIC_ARCHS:
        sizing = ModelSizing(get_config(arch))
        prof = decode_profile(
            name=arch,
            param_bytes=sizing.cfg.num_params() * 2,
            kv_bytes=sizing.cache_bytes(shape),
            step_flops=sizing.model_flops(shape),
            num_chips=ANALYTIC_CHIPS,
        )
        for policy in registered_policies().values():
            pred = predict(prof, policy)
            rows.append((
                f"analytic_decode[{arch},{policy.name}]",
                pred.step_s * 1e6,
                f"{shape.global_batch/pred.step_s:.0f}tok/s"
                + ("" if pred.fits else " DOES-NOT-FIT"),
            ))
    for row in rows:
        emit(*row)
    return rows


def phase_table(phase: str, best: PolicyPrediction,
                preds: list[PolicyPrediction], top: int = 3) -> str:
    """The planner's top-``top`` candidates for ``phase``, feasible first,
    fastest first, the pick marked (the reference's ``PhasePlan.table``)."""
    ranked = sorted(preds, key=lambda p: (not p.fits, p.step_s))
    show = ranked[:top]
    if best not in show:
        show.append(best)
    lines = [f"phase={phase} picked={best.policy}"]
    for p in show:
        mark = "=> " if p.policy == best.policy else "   "
        lines.append(f"{mark}{p.explain()}")
    return "\n".join(lines)


def describe(bundle, batch_slots: int, max_len: int, prefill_chunk: int) -> dict:
    """What the server ran under: the policy's JSON, no mesh, and the
    planner's pick and top 3 for the decode and prefill profiles of the
    shape (the reference's ``Runtime.describe()``).  One card realizes
    only ``hbm_resident``, so only it is eligible."""
    shape = ShapeSpec("serve", max_len, batch_slots, "decode")
    profiles = {
        "decode": bundle.decode_workload(shape),
        "prefill": bundle.prefill_workload(shape, chunk_tokens=prefill_chunk),
    }
    phases = {}
    for name, prof in profiles.items():
        best, preds = plan(prof, **donor_allow_flags(None))
        phases[name] = {"picked": best.policy,
                        "top3": phase_table(name, best, preds)}
    return {
        "policy": json.loads(get_policy("hbm_resident").to_json()),
        "mesh_axes": None,
        "phases": phases,
    }


def serve(device, out_path=None, *, requests: int = 8, prompt_len: int = 24,
          max_new: int = 12) -> dict:
    """Serve-loop throughput with the prefill and decode phases split out,
    one entry per prefill chunk."""
    from repro_torch.serve import Request, ServeConfig, Server

    arch = "yi-6b"
    bundle = get_smoke_bundle(arch)
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    results = {}
    for chunk in (8, 32):
        cfg = ServeConfig(batch_slots=4, max_len=96, prefill_chunk=chunk)
        server = Server(bundle, cfg, params, device=device)
        server.add_requests(
            Request(
                rid=i,
                prompt=rng.integers(1, bundle.cfg.vocab, prompt_len).astype(np.int32),
                max_new_tokens=max_new,
            )
            for i in range(requests)
        )
        server.run_until_done()
        tp = server.throughput()
        key = f"{arch},chunk{chunk}"
        results[key] = {
            "arch": arch,
            "prefill_chunk": chunk,
            "batch_slots": cfg.batch_slots,
            "requests": requests,
            "prompt_len": prompt_len,
            "max_new": max_new,
            **describe(bundle, cfg.batch_slots, cfg.max_len, chunk),
            **tp,
        }
        emit(f"serve_prefill[{key}]", 1e6 / max(tp["prefill_tps"], 1e-9),
             f"{tp['prefill_tps']:.1f}tok/s")
        emit(f"serve_decode[{key}]", 1e6 / max(tp["decode_tps"], 1e-9),
             f"{tp['decode_tps']:.1f}tok/s")
    out_path = pathlib.Path(out_path or OUT)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=2, sort_keys=True))
    return results


def main(device) -> None:
    analytic()
    serve(device)
