"""The port's serving drivers run on the CPU at a small size.

``repro_torch.tools.serve_soak``, ``serve_chaos`` and ``policy_smoke``,
``repro_torch.examples.serve_llm`` (with ``--asyncio``), the launcher's
``--max-queue``/``--preempt`` and ``bench_llm_inference``'s queued leg:
each exits 0, asserts what it asserts, and writes what it writes.
"""

import json

import pytest
import torch

from repro_torch.benchmarks import bench_llm_inference
from repro_torch.examples import serve_llm
from repro_torch.launch import serve as launch_serve
from repro_torch.tools import policy_smoke, serve_chaos, serve_soak


def test_soak_drains_with_preemption_and_greedy_identity(tmp_path):
    out = tmp_path / "serve.json"
    assert serve_soak.main(["--device", "cpu", "--requests", "24", "--out", str(out)]) == 0
    row = json.loads(out.read_text())["soak"]
    assert row["preemptions"] >= 1 and row["promotions"] >= 1
    assert row["spill_tier"] == "hbm" and row["requests"] == 24
    assert row["latency_p99_s"] >= row["latency_p50_s"] > 0


def test_chaos_heals_under_the_seeded_plan(tmp_path, monkeypatch):
    out = tmp_path / "chaos.json"
    # a stall well past the deadline (8 x the step EWMA) of a loaded host
    plan = serve_chaos.build_plan
    monkeypatch.setattr(serve_chaos, "build_plan", lambda seed: plan(seed, 3.0))
    assert serve_chaos.main(["--device", "cpu", "--requests", "40", "--out", str(out)]) == 0
    row = json.loads(out.read_text())["chaos"]
    assert row["completion_rate"] == 1.0 and row["policy"] == "hbm_resident"
    assert row["tier_losses"] == row["evacuations"] == row["spill_corruptions"] == 1
    assert row["migration_retries"] >= 1 and row["watchdog_stalls"] >= 1
    fired = {f["kind"] for f in row["fault_plan"]["fired"]}
    assert fired == {"stall", "spill_corrupt", "tier_loss", "migrate_fail"}
    assert row["fault_plan"] == plan(0, 3.0).to_json() | {
        "fired": row["fault_plan"]["fired"]}


def test_policy_smoke_replans_a_custom_policy():
    assert policy_smoke.main(["--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        policy_smoke.main(["--device", "cpu", "--policy", "kv_host"])


def test_serve_llm_example_sync_and_asyncio():
    out = serve_llm.main(["--device", "cpu", "--asyncio", "--requests", "4",
                          "--max-new", "5"])
    runs = out["hbm_resident"]
    assert [len(t) for t in runs["sync"]] == [5] * 4
    assert [len(t) for t in runs["asyncio"]] == [5] * 4


def test_launcher_bounded_queue_and_preemption():
    tp = launch_serve.main(["--arch", "yi-6b", "--smoke", "--requests", "7", "--slots",
                            "2", "--max-len", "64", "--prefill-chunk", "4", "--device",
                            "cpu", "--max-queue", "2", "--preempt", "--max-new", "6"])
    assert tp["decode_tokens"] == 7 * 6


def test_bench_queued_leg(tmp_path):
    out = tmp_path / "bench.json"
    row = bench_llm_inference.queued(torch.device("cpu"), out, requests=8, prompt_len=12,
                                     max_new=6)
    saved = json.loads(out.read_text())["yi-6b-smoke,queued"]
    assert saved == json.loads(json.dumps(row))
    assert row["preemptions"] >= 1 and row["promotions"] == row["preemptions"]
    assert row["ttft_p99_s"] >= row["ttft_p50_s"] > 0
    assert all(len(t) == 6 for t in row["tokens"])
