"""The port's paper microbenchmarks on the CPU, against the JAX reference's.

Each ported ``bench_*`` runs at small sizes on the CPU and prints rows
that parse as ``name,us_per_call,derived``; with the port's active system
set to the reference's TPU values, its datapath-only ``analytic_*`` rows
equal the reference module's rows (captured from its stdout; nothing in
``benchmarks/`` changes).  The runner and the calibration launcher run
end to end on the CPU.
"""

import importlib
import json

import jax
import pytest
import torch

from repro.api import SPEC_SYSTEM as REF_SPEC
from repro.core import hardware as rH
from repro.kernels.blocked_matmul import best_tiling as ref_best_tiling
from repro_torch.benchmarks import run as prun
from repro_torch.core import hardware as pH
from repro_torch.launch import calibrate as pcalibrate

from test_torch_datapath import port_system

jax.config.update("jax_platform_name", "cpu")

#: module -> (module-level size lists to shrink, small values); the
#: reference's modules are shrunk the same way where they have them
SMALL = {
    "bench_membw": {"SIZES": [2**12, 2**14]},
    "bench_copy": {"SIZES": [2**12, 2**14]},
    "bench_latency": {"SIZES": [2**6, 2**8], "CHAIN": 16},
    "bench_gemm": {},
    "bench_managed_vs_system": {"SIZES": [2**12]},
}


def _rows(text: str) -> list[tuple[str, float, str]]:
    rows = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, us, derived = line.rsplit(",", 2)
        rows.append((name, float(us), derived))
    return rows


@pytest.fixture
def tpu_valued_port():
    """The port's active system set to the reference's TPU values."""
    prev = pH.set_active_system(port_system(REF_SPEC))
    yield
    pH.set_active_system(prev)


def _shrink(monkeypatch, module, name):
    for attr, value in SMALL[name].items():
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, value)


@pytest.mark.parametrize("name", list(SMALL))
def test_bench_runs_on_cpu_and_prints_rows(name, monkeypatch, capsys):
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    _shrink(monkeypatch, mod, name)
    if name == "bench_gemm":
        monkeypatch.setitem(mod.SIZES, "cpu", ((256, torch.float32),
                                               (256, torch.bfloat16)))
    mod.main("cpu")
    rows = _rows(capsys.readouterr().out)
    measured = [r for r in rows if not r[0].startswith("analytic_")]
    assert measured and all(us > 0 for _, us, _ in measured)
    assert all(r[2] for r in rows)
    assert not any("L2-resident" in r[2] for r in rows)    # a card label only
    if name == "bench_gemm":
        names = {r[0] for r in measured}
        assert {"torch_gemm[256,float32]", "torch_gemm[256,bfloat16]",
                "blocked_gemm[256,bfloat16,bm256,bn128,bk256]"} <= names
        assert all("AI=" in d for n, _, d in measured if n.startswith("blocked"))


@pytest.mark.parametrize("name", ["bench_membw", "bench_copy", "bench_latency",
                                  "bench_managed_vs_system"])
def test_analytic_rows_equal_reference(name, monkeypatch, capsys, tpu_valued_port):
    ref_mod = importlib.import_module(f"benchmarks.{name}")
    _shrink(monkeypatch, ref_mod, name)
    ref_mod.main()
    want = [r for r in _rows(capsys.readouterr().out) if r[0].startswith("analytic_")]
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    _shrink(monkeypatch, mod, name)
    mod.main("cpu")
    got = [r for r in _rows(capsys.readouterr().out) if r[0].startswith("analytic_")]
    assert want and got == want


def test_gemm_analytic_rows_equal_reference_at_a_given_tiling(capsys, tpu_valued_port):
    from benchmarks import bench_gemm as ref_gemm
    from repro_torch.benchmarks import bench_gemm

    ref_gemm.analytic()
    want = capsys.readouterr().out
    bench_gemm.analytic(tiling=ref_best_tiling(16384, 16384, 16384))
    assert capsys.readouterr().out == want
    assert len(_rows(want)) == 3 + 9


def test_gemm_analytic_verdict_under_the_h100_spec(capsys):
    """The H100 verdict the study reports: at the kernel's best tiling the
    traffic model calls bf16 and int8 memory-bound and f32 compute-bound."""
    from repro_torch.benchmarks import bench_gemm

    bench_gemm.analytic()
    rows = {n: d for n, _, d in _rows(capsys.readouterr().out)}
    assert rows["analytic_gemm[hbm,bfloat16]"].endswith("memory-bound")
    assert rows["analytic_gemm[hbm,int8]"].endswith("memory-bound")
    assert rows["analytic_gemm[hbm,float32]"] == "67.0TF/s compute-bound"
    assert rows["analytic_gemm[A=host,B=host]"].endswith("memory-bound")


def test_runner_on_cpu(monkeypatch, capsys, tmp_path):
    from repro_torch.benchmarks import bench_gemm
    from repro_torch.core import calibration as pcal

    monkeypatch.setitem(bench_gemm.SIZES, "cpu", ((128, torch.float32),))
    assert prun.main(["--device", "cpu", "--only", "bench_gemm"]) == 0
    out = capsys.readouterr().out
    assert "# ==== bench_gemm ====" in out and "FAILED" not in out
    assert any(r[0] == "torch_gemm[128,float32]" for r in _rows(out))
    # --calibration activates the measured terms for the analytic rows
    cal = pcal.Calibration(backend="cpu", num_devices=1, created="x")
    cal.terms["hbm_bandwidth"] = pcal.TermCalibration(
        term="hbm_bandwidth", spec=3.35e12, measured=1e12, unit="B/s", source="t")
    path = cal.save(tmp_path / "calibration.json")
    prev = pH.get_active_system()
    try:
        assert prun.main(["--device", "cpu", "--only", "bench_gemm",
                          "--calibration", str(path)]) == 0
        assert pH.get_active_system().term_value("hbm_bandwidth") == 1e12
    finally:
        pH.set_active_system(prev)
    assert "# calibration:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            prun.main(["--only", "bench_gemm"])          # cuda is the default


def test_calibrate_launcher_on_cpu(tmp_path, capsys):
    out, report = tmp_path / "c" / "calibration.json", tmp_path / "r.json"
    args = ["--device", "cpu", "--out", str(out), "--report", str(report),
            "--sizes", "16384,65536,131072", "--repeats", "2"]
    assert pcalibrate.main(args + ["--gate", "1e9"]) == 0
    text = capsys.readouterr().out
    assert "spec provenance kept for" in text and "drift gate OK" in text
    obj = json.loads(out.read_text())
    assert obj["format_version"] == 1 and set(obj["terms"]) >= {"hbm_bandwidth"}
    assert set(json.loads(report.read_text())["per_term"]) == {"hbm_bandwidth"}
    assert pcalibrate.main(args + ["--gate", "1e9", "--gate-term",
                                   "hbm_bandwidth=0"]) == 1
    assert "DRIFT GATE FAILED" in capsys.readouterr().out
