"""The port's step counts, roofline and dry run, mirroring
``tests/test_roofline.py`` and ``tests/test_hlo_analysis.py``.

``analyze_step`` counts product FLOPs op by op on ``meta``; the reference
counts ``dot``/``convolution`` in compiled HLO.  On a matmul and an MLP the
two are equal; on the smoke models' ``train_loss`` (no grad, ``remat=
"none"``), ``prefill`` and ``decode`` they are equal too (held within 1 %,
decode included because XLA kept its one-row products as dots here).

One case differs, and is held to its reason: a Mamba-2 ``train_loss``
counts more in the port.  The plain SSD scan computes each chunk's state
summary (``S``, an einsum) even where no state is returned; XLA removes
the last chunk's summary as dead code, eager PyTorch runs it.  With one
chunk (S = 32) that is the whole summary, which is what the test checks.
"""

import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ShapeSpec as JShape
from repro.configs import smoke_config as jax_smoke_config
from repro.core.hardware import get_active_system as jax_system
from repro.core.hlo_analysis import HloCost, analyze_hlo_text
from repro.core.roofline import report_from_cost as jax_report
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.models.sharding import defs_to_shapes
from repro_torch.configs import SHAPES, ShapeSpec, list_archs, smoke_config
from repro_torch.core.hardware import get_active_system
from repro_torch.core.op_analysis import StepCost, analyze_step
from repro_torch.core.roofline import (
    RooflineReport,
    load_reports,
    markdown_table,
    report_from_cost,
    report_from_step,
    save_reports,
)
from repro_torch.launch import dryrun
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import zeros_like_defs
from repro_torch.tools import audit as audit_tool
from repro_torch.tools import render_experiments

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# The three terms
# ---------------------------------------------------------------------------

def _reference_system():
    """The reference's system with the port's chip constants (H100)."""
    sys_ = jax_system()
    chip = get_active_system().chip
    return dataclasses.replace(sys_, pod=dataclasses.replace(sys_.pod, chip=dataclasses.replace(
        sys_.chip, peak_bf16_flops=chip.peak_bf16_flops, hbm_bandwidth=chip.hbm_bandwidth)))


@pytest.mark.parametrize("flops,nbytes", [(2e12, 5e9), (1e9, 3.35e12), (0.0, 0.0)])
def test_report_from_cost_equals_the_reference_term_for_term(flops, nbytes):
    kw = dict(arch="yi-6b", shape="decode_32k", mesh_name="1", num_chips=1,
              model_flops=6e11, model_bytes=2e9, notes="n")
    got = report_from_cost(StepCost(flops=flops, hbm_bytes=nbytes), **kw)
    want = jax_report(HloCost(flops=flops, hbm_bytes=nbytes), system=_reference_system(), **kw)
    assert got.to_json() == want.to_json()


def test_terms_are_priced_on_the_card():
    chip = get_active_system().chip
    r = report_from_cost(StepCost(flops=989e12, hbm_bytes=3.35e12 / 2), arch="a",
                         shape="s", mesh_name="1", num_chips=1, model_flops=989e12 / 2,
                         model_bytes=3.35e12 / 4)
    assert r.compute_s == pytest.approx(989e12 / chip.peak_bf16_flops)
    assert r.memory_s == pytest.approx(0.5 * 3.35e12 / chip.hbm_bandwidth)
    assert r.collective_s == 0.0 and r.collective_by_link == {}
    assert r.dominant == "compute" and r.bound_step_s == r.compute_s
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.bw_fraction == pytest.approx(0.25)


def test_save_load_markdown(tmp_path):
    r = report_from_cost(StepCost(flops=1e12, hbm_bytes=1e9), arch="a", shape="s",
                         mesh_name="1", num_chips=1, model_flops=1e12)
    path = tmp_path / "r.json"
    save_reports([r], str(path))
    assert load_reports(str(path)) == [r]
    assert RooflineReport.from_json(r.to_json()) == r
    table = markdown_table([r])
    assert "| a | s | 1 |" in table and table.count("\n") == 2


# ---------------------------------------------------------------------------
# Counted FLOPs against the reference's HLO count
# ---------------------------------------------------------------------------

def _hlo_flops(fn, *args) -> float:
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text()).flops


def test_matmul_flops_exact():
    M, K, N = 64, 96, 48
    want = _hlo_flops(lambda a, b: a @ b, jnp.zeros((M, K)), jnp.zeros((K, N)))
    cost = analyze_step(lambda a, b: a @ b, torch.empty(M, K), torch.empty(K, N))
    assert cost.flops == want == 2 * M * N * K
    assert cost.dot_flops == cost.flops and cost.conv_flops == 0
    # bytes: both operands read once, the product written once
    assert cost.hbm_bytes == 4 * (M * K + K * N + M * N)
    assert cost.argument_bytes == 4 * (M * K + K * N) and cost.output_bytes == 4 * M * N


def test_mlp_flops_exact():
    B, S, d, ff = 2, 8, 32, 128

    def jmlp(x, w1, b1, w2):
        return jax.nn.gelu(x @ w1 + b1) @ w2

    def tmlp(x, w1, b1, w2):
        return torch.nn.functional.gelu(x @ w1 + b1) @ w2

    shapes = [(B, S, d), (d, ff), (ff,), (ff, d)]
    want = _hlo_flops(jmlp, *[jnp.zeros(s) for s in shapes])
    cost = analyze_step(tmlp, *[torch.empty(s) for s in shapes])
    assert cost.flops == want == 2 * 2 * B * S * d * ff


def test_counts_match_torchs_flop_counter():
    """The product formulas are torch.utils.flop_counter's."""
    from torch.utils.flop_counter import FlopCounterMode

    def f(x, w, a, b, k, c, m):
        y = torch.bmm(a, b) + 1
        z = torch.nn.functional.conv1d(x, k, groups=4, padding=1)
        return torch.addmm(c, w[:3], m), y, z

    args = (torch.randn(2, 8, 16), torch.randn(6, 8), torch.randn(4, 5, 6),
            torch.randn(4, 6, 7), torch.randn(8, 2, 3), torch.randn(3, 5), torch.randn(8, 5))
    with FlopCounterMode(display=False) as fc:
        f(*args)
    assert analyze_step(f, *args).flops == fc.get_total_flops()


def test_out_dtype_products_are_counted():
    a, b = torch.empty(4, 8, 16, dtype=torch.bfloat16), torch.empty(4, 16, 8,
                                                                    dtype=torch.bfloat16)
    cost = analyze_step(lambda a, b: torch.bmm(a, b, out_dtype=torch.float32), a, b)
    assert cost.flops == 2 * 4 * 8 * 16 * 8


def test_views_move_nothing_and_updates_write_the_slice():
    buf = torch.empty(64, 32)
    cost = analyze_step(lambda t: t[3:5].reshape(-1).view(2, 32).transpose(0, 1), buf)
    assert cost.hbm_bytes == 0 and cost.flops == 0
    rows = torch.empty(2, 32)
    idx = torch.tensor([1, 7])
    cost = analyze_step(lambda t, i, r: t.index_put_((i,), r), buf, idx, rows)
    assert cost.hbm_bytes == 2 * rows.numel() * 4 + idx.numel() * 8
    assert cost.alias_bytes == buf.numel() * 4          # handed back in place


def _pair(arch):
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    return jb, tb


def _both(arch, mode, B=2, S=32):
    """(reference HLO FLOPs, the port's counted FLOPs) of one smoke step."""
    jb, tb = _pair(arch)
    js, ts = JShape("s", S, B, mode), ShapeSpec("s", S, B, mode)
    jp = defs_to_shapes(jb.param_defs(), "float32")
    jbatch = defs_to_shapes(jb.input_defs(js), "float32")
    tp = zeros_like_defs(tb.param_defs(), "float32", "meta")
    tbatch = zeros_like_defs(tb.input_defs(ts), "float32", "meta")
    if mode == "train":
        want = _hlo_flops(lambda p, b: jb.train_loss(p, b, remat="none")[0], jp, jbatch)

        def step(p, b):
            with torch.no_grad():
                return tb.train_loss(p, b, remat="none")
        return want, analyze_step(step, tp, tbatch).flops
    jc = defs_to_shapes(jb.cache_defs(B, S), "float32")
    tc = zeros_like_defs(tb.cache_defs(B, S), "float32", "meta")
    jfn = jb.prefill if mode == "prefill" else jb.decode_step
    tfn = tb.prefill if mode == "prefill" else tb.decode_step
    want = _hlo_flops(lambda p, b, c: jfn(p, b, c), jp, jbatch, jc)

    def step(p, b, c):
        with torch.no_grad():
            return tfn(p, b, c)
    return want, analyze_step(step, tp, tbatch, tc).flops


@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_smoke_step_flops_within_one_percent_of_the_reference(arch, mode):
    want, got = _both(arch, mode)
    assert want > 0 and abs(got - want) <= 0.01 * want, (got, want)


def test_ssm_train_counts_the_summary_xla_drops():
    want, got = _both("mamba2-780m", "train")
    cfg = smoke_config("mamba2-780m")
    spec = cfg.ssm
    H, P, N = spec.n_heads(cfg.d_model), spec.head_dim, spec.d_state
    B, S = 2, 32
    # the one chunk's summary einsum "bcjh,bcjh,bcjhp,bcjn->bchpn", a
    # product over the chunk's S positions, in every layer
    summary = 2.0 * B * H * P * N * S * cfg.n_layers
    assert got - want == summary


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

SMOKE_SHAPES = [ShapeSpec("smoke_train", 64, 2, "train"),
                ShapeSpec("smoke_prefill", 64, 2, "prefill"),
                ShapeSpec("smoke_decode", 64, 2, "decode")]


@pytest.mark.parametrize("arch", list_archs())
def test_lower_cell_ok_for_every_smoke_arch_in_each_mode(arch):
    for shape in SMOKE_SHAPES:
        rec, cost = dryrun.lower_cell(arch, shape, smoke=True, verbose=False)
        assert rec["status"] == "ok" and rec["mesh"] == "1"
        assert cost.flops > 0 and cost.hbm_bytes > 0
        ma = rec["memory_analysis"]
        assert ma["peak_bytes_per_device"] >= ma["argument_bytes_per_device"] > 0
        assert ma["fits_one_card"]
        rl = rec["roofline"]
        assert rl["hlo_flops"] == cost.flops and rl["collective_s"] == 0.0
        assert rl["hlo_bytes"] == cost.hbm_bytes
        assert rl["bound_step_s"] == max(rl["compute_s"], rl["memory_s"])


def test_lower_cell_full_yi_decode_32k():
    rec, cost = dryrun.lower_cell("yi-6b", "decode_32k", verbose=False)
    shape = SHAPES["decode_32k"]
    bundle = ModelBundle(dryrun.get_config("yi-6b"))
    assert rec["status"] == "ok"
    assert rec["roofline"]["model_bytes"] == bundle.model_bytes(shape)
    # the cache alone (128 rows x 32768 positions) outgrows one card
    assert rec["memory_analysis"]["argument_bytes_per_device"] > \
        bundle.cache_bytes(shape)
    assert not rec["memory_analysis"]["fits_one_card"]
    # the counted bytes are unfused: at least the must-move floor
    assert cost.hbm_bytes >= bundle.model_bytes(shape)


def _reference_record_keys():
    """The keys of the reference dry run's record, read from its source
    (importing it would set XLA_FLAGS for the process)."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "record" for t in node.targets):
            keys = {k.value: v for k, v in zip(node.value.keys, node.value.values)}
            return {name: ({k.value for k in v.keys} if isinstance(v, ast.Dict) else None)
                    for name, v in keys.items()}
    raise AssertionError("no record dict in the reference dry run")


def test_record_keys_are_the_references():
    want = _reference_record_keys()
    rec, _ = dryrun.lower_cell("olmo-1b", SMOKE_SHAPES[2], smoke=True, verbose=False)
    assert set(rec) == set(want)
    for name, inner in want.items():
        if inner is not None:
            assert inner <= set(rec[name]), name
    assert rec["collectives"] == []            # one card: no mesh (ROADMAP A10)


@pytest.mark.parametrize("flag", ["--multipod-only", "--singlepod-only", "--optimized"])
def test_mesh_flags_name_a10(flag):
    with pytest.raises(SystemExit, match="A10"):
        dryrun.main([flag])


def test_cli_one_cell_and_render(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        ("yi-6b", "decode_32k", "ok")]
    render_experiments.main(str(out))
    text = capsys.readouterr().out
    assert "| yi-6b | decode_32k | 1 | ok |" in text and "ROADMAP A10" in text
    skipped = {"arch": "olmo-1b", "shape": "long_500k", "mesh": "1", "status": "skipped",
               "reason": "pure full attention at 500k"}
    assert "| olmo-1b | long_500k | 1 | skipped |" in render_experiments.render([skipped])


def test_report_from_step_of_a_served_step():
    bundle = ModelBundle(smoke_config("yi-6b"))
    shape = ShapeSpec("s", 64, 2, "decode")
    _, specs = dryrun.input_specs("yi-6b", shape, smoke=True)

    def step(p, b, c):
        with torch.no_grad():
            return bundle.decode_step(p, b, c)

    report, cost = report_from_step(step, specs["params"], specs["batch"], specs["caches"],
                                    arch="yi-6b", shape="s",
                                    model_flops=bundle.model_flops(shape),
                                    model_bytes=bundle.model_bytes(shape))
    assert report.mesh == "1" and report.hlo_flops == cost.flops > 0
    # the memory term is priced on the must-move floor; the counted,
    # unfused bytes stay a diagnostic
    chip = get_active_system().chip
    assert report.hlo_bytes == cost.hbm_bytes > report.model_bytes
    assert report.memory_s == pytest.approx(report.model_bytes / chip.hbm_bandwidth)
    assert report.dominant == "memory" and report.bound_step_s == report.memory_s
    assert report.bw_fraction == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

def test_audit_selftest_and_lint_pass(tmp_path):
    out = tmp_path / "audit.json"
    assert audit_tool.main(["--lint", "--selftest", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and all(report["selftest"]["checks"].values())
    assert len(report["selftest"]["checks"]) == 12


def test_audit_transfer_section_on_the_cpu(tmp_path):
    out = tmp_path / "audit.json"
    assert audit_tool.main(["--transfer-audit", "--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())["transfer_audit"]
    assert report["device"] == "cpu"
    execs = report["executables"]
    assert set(execs) == {"build:decode", "build:prefill", "build:insert"}
    assert all(r["ok"] and r["donation_coverage"] == 1.0 for r in execs.values())


def test_audit_transfer_section_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    # the transfer audit reads the card's copy records: without --device it
    # runs on the card or raises, never on the CPU in silence
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        audit_tool.main(["--transfer-audit", "--out", str(tmp_path / "audit.json")])
