"""Paper Fig. 17: LLM decode throughput against physical memory placement.

Counterpart of the reference's ``benchmarks/bench_llm_inference.py``,
its four legs:

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
* **queued** — requests arriving over time (one every ``arrival_every``
  decode ticks) into a slot pool they oversubscribe, with planner-priced
  preemption on (on a card the spill tier is pinned host memory): p50/p99
  of per-request completion latency and time to first token, merged into
  ``build/BENCH_serve.json``.
"""

from __future__ import annotations

import dataclasses
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


def queued(device, out_path=None, *, requests: int = 16, prompt_len: int = 16,
           max_new: int = 8, arrival_every: int = 2, bundle=None, params=None,
           config=None, prompts=None) -> dict:
    """Queued-arrival workload: per-request latency under oversubscription.
    Requests arrive one every ``arrival_every`` decode ticks into the slots
    with planner-priced preemption on (``preempt_wait=4``); even rids decode
    greedily, odd ones sample.  Each request's submit / first-token /
    finish stamps give queue-inclusive completion latency and time to
    first token, whose p50/p99 land in the artifact beside the spill tier
    and the spill and restore seconds.

    By default the reference's leg and shape: the smoke yi-6b, weights
    from seed 0, ``requests`` random prompts of ``prompt_len`` tokens into
    2 slots of 96 positions, prefill chunk 8, the planner's policy.  A caller
    serving a full model passes its ``bundle`` and ``params``, the
    ``config`` (a ``ServeConfig``: slots, ``max_len``, chunk, policy) and
    the ``prompts``."""
    from repro_torch.serve import Request, SamplingParams, ServeConfig, Server

    if bundle is None:
        bundle = get_smoke_bundle("yi-6b")
        params = bundle.init_params(torch.Generator(device=device).manual_seed(0))
    if config is None:
        config = ServeConfig(batch_slots=2, max_len=96, prefill_chunk=8)
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, bundle.cfg.vocab, prompt_len).astype(np.int32)
                   for _ in range(requests)]
    arch = bundle.cfg.name
    server = Server(
        bundle,
        dataclasses.replace(config, max_queue=len(prompts), preempt=True, preempt_wait=4),
        params, device=device,
    )
    reqs = [
        Request(
            rid=i, prompt=p, max_new_tokens=max_new,
            sampling=(SamplingParams() if i % 2 == 0 else
                      SamplingParams(temperature=0.8, top_k=20, seed=i)),
        )
        for i, p in enumerate(prompts)
    ]
    pending = list(reqs)
    tick = 0
    while pending or server.has_work():
        while pending and tick >= arrival_every * (len(reqs) - len(pending)):
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        if tick >= 50_000:
            raise RuntimeError("queued-arrival loop did not drain")
    if not all(r.done for r in reqs):
        raise RuntimeError(f"undrained requests {[r.rid for r in reqs if not r.done]}")
    lat = np.asarray([r.finished_s - r.submitted_s for r in reqs])
    ttft = np.asarray([r.first_token_s - r.submitted_s for r in reqs])
    stats = server.stats()
    row = {
        "arch": arch,
        "batch_slots": config.batch_slots,
        "max_len": config.max_len,
        "prefill_chunk": config.prefill_chunk,
        "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts],
        "max_new": max_new,
        "arrival_every_ticks": arrival_every,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "preemptions": stats["preemptions"],
        "promotions": stats["promotions"],
        "peak_queue": stats["peak_queue"],
        "spill_s": stats["spill_s"],
        "restore_s": stats["restore_s"],
        "spill_tier": server.runtime.spill_placement().to_str(),
        "tokens": [r.out_tokens for r in reqs],
        # under graphs: the kernels one replay launches, and all replays'
        "graph_launches": server.engine.graph_launches,
        "replay_launches": dict(server.engine.replay_launches),
        "decode_replays": server.engine.counters["decode_replays"],
        "prefill_replays": server.engine.counters["prefill_replays"],
        **server.runtime.describe(),
        **server.throughput(),
    }
    emit(f"serve_queued_p50[{arch}]", row["latency_p50_s"] * 1e6,
         f"{row['latency_p50_s'] * 1e3:.1f}ms")
    emit(f"serve_queued_p99[{arch}]", row["latency_p99_s"] * 1e6,
         f"{row['latency_p99_s'] * 1e3:.1f}ms ({stats['preemptions']} preemptions)")
    out_path = pathlib.Path(out_path or OUT)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        results = json.loads(out_path.read_text())
    except (OSError, ValueError):
        results = {}
    results[f"{arch},queued"] = row
    out_path.write_text(json.dumps(results, indent=2, sort_keys=True))
    return row


def main(device) -> None:
    analytic()
    serve(device)
    queued(device)
    measured(device)
