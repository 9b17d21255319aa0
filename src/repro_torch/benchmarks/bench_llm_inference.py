"""Paper Fig. 17: LLM decode throughput against physical memory placement.

Counterpart of the reference's ``benchmarks/bench_llm_inference.py``,
three of its four legs:

* **measured** — smoke yi-6b decoding 32 tokens for 4 rows after a
  64-token prompt under ``hbm_resident``, ``kv_host`` and
  ``weights_stream``, each realized by the serving ``Runtime`` (on the
  card: the KV cache or the weights in pinned host memory, streamed layer
  by layer inside the CUDA graphs); the mean decode step and tok/s per
  policy, and the greedy tokens, which must agree across the three.

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

Not ported: the **queued** leg needs preemption (ROADMAP A11).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.core.placement import donor_allow_flags, registered_policies
from repro_torch.core.planner import PolicyPrediction, decode_profile, plan, predict
from repro_torch.models.model_zoo import ModelSizing, get_smoke_bundle

#: where the serve leg writes its artifact
OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "BENCH_serve.json"

ANALYTIC_ARCHS = ("yi-6b", "gemma3-27b", "deepseek-v2-236b")
ANALYTIC_CHIPS = 256
#: the measured leg's policies and shape (the reference's)
MEASURED_POLICIES = ("hbm_resident", "kv_host", "weights_stream")
MEASURED_SHAPE = dict(batch=4, prompt_len=64, new_tokens=32)


def measured(device, *, batch: int = MEASURED_SHAPE["batch"],
             prompt_len: int = MEASURED_SHAPE["prompt_len"],
             new_tokens: int = MEASURED_SHAPE["new_tokens"]) -> dict:
    """Decode under each of :data:`MEASURED_POLICIES`, through the serving
    ``Runtime``: ``batch`` rows prefill ``prompt_len`` tokens in one
    dispatch, then decode ``new_tokens`` greedy steps.  Returns per policy
    the mean decode step (all steps, as the reference divides its loop by
    the token count), the runtime's step EWMA, the tokens and what the
    runtime ran under."""
    from repro_torch.serve import Request, ServeConfig, Server

    bundle = get_smoke_bundle("yi-6b")
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, bundle.cfg.vocab, prompt_len + 1).astype(np.int32)
               for _ in range(batch)]
    out = {}
    for name in MEASURED_POLICIES:
        cfg = ServeConfig(batch_slots=batch, max_len=prompt_len + new_tokens + 8,
                          prefill_chunk=prompt_len, policy=name)
        server = Server(bundle, cfg, params, device=device)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]
        server.add_requests(reqs)
        server.run_until_done()
        c = server.stats()
        step_s = c["decode_s"] / c["decode_steps"]
        out[name] = {
            "step_s": step_s,
            "measured_step_s": server.engine.measured_step_s,
            "decode_steps": c["decode_steps"],
            "tokens": [r.out_tokens for r in reqs],
            **server.runtime.describe(),
        }
        emit(f"decode[{name}]", step_s * 1e6, f"{batch / step_s:.1f}tok/s")
    return out


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


def describe(bundle, batch_slots: int, max_len: int, prefill_chunk: int,
             device, policy) -> dict:
    """What the server ran under: its policy's JSON, no mesh, and the
    planner's pick and top 3 for the decode and prefill profiles of the
    shape (the reference's ``Runtime.describe()``), over the tiers
    ``device`` realizes."""
    shape = ShapeSpec("serve", max_len, batch_slots, "decode")
    profiles = {
        "decode": bundle.decode_workload(shape),
        "prefill": bundle.prefill_workload(shape, chunk_tokens=prefill_chunk),
    }
    phases = {}
    for name, prof in profiles.items():
        best, preds = plan(prof, **donor_allow_flags(None, device))
        phases[name] = {"picked": best.policy,
                        "top3": phase_table(name, best, preds)}
    return {
        "policy": json.loads(policy.to_json()),
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
            **describe(bundle, cfg.batch_slots, cfg.max_len, chunk, device,
                       server.policy),
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
    measured(device)
