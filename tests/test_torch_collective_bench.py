"""The collective microbenchmarks (paper Figs. 13, 14, 18, 19) and the
scale what-if, against the reference's ``benchmarks/bench_{pingpong,
internode,collectives}.py`` and ``tools/whatif_scale.py``:

* each benchmark's analytic rows carry the reference's names, and each
  value is its formula on the port's ``SystemSpec`` (NVLink 4, InfiniBand,
  PCIe);
* the measured rows come out of 4 gloo ranks and parse;
* the port's and the reference's ``wire_bytes`` agree, and
  ``whatif_scale``'s gemma3-27b table is the reference's formula fed the
  port's constants.
"""

import concurrent.futures
import importlib
import math
import re

import pytest

from repro.core.datapath import wire_bytes as jax_wire_bytes
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.configs import SHAPES as JAX_SHAPES, get_config as jax_get_config
from repro_torch.benchmarks import run as prun
from repro_torch.core.datapath import collective_bound, wire_bytes
from repro_torch.core.hardware import Link, get_active_system
from repro_torch.tools import whatif_scale

BENCHES = ["bench_pingpong", "bench_internode", "bench_collectives"]
def _rows(text):
    """``name,us,derived`` rows (a name may hold commas)."""
    out = []
    for line in text.splitlines():
        name, us, derived = line.rsplit(",", 2)
        assert re.fullmatch(r"\d+\.\d\d", us) and derived, line
        out.append((name, float(us), derived))
    return out


def _formula(name: str) -> float:
    """The microseconds an analytic row's formula gives on the port's
    active system."""
    c = get_active_system()
    if m := re.fullmatch(r"analytic_pingpong\[ici,(\d+)hops\]", name):
        return 2 * int(m[1]) * c.link_latency(Link.ICI) * 1e6
    if name == "analytic_pingpong[dcn]":
        return 2 * c.link_latency(Link.DCN) * 1e6
    if name == "analytic_pingpong[host]":
        return 2 * c.link_latency(Link.PCIE) * 1e6
    if m := re.fullmatch(r"analytic_internode\[(\d+)streams,(\d+)B\]", name):
        streams, size = int(m[1]), int(m[2])
        return (c.link_latency(Link.DCN) + size / (c.link_bandwidth(Link.DCN) * streams)) * 1e6
    m = re.fullmatch(r"analytic_(all_reduce|all_gather)\[(model|data|pod),(\d+)B\]", name)
    link, size = {"model": (Link.ICI, 16), "data": (Link.ICI, 16), "pod": (Link.DCN, 2)}[m[2]]
    return int(m[3]) / collective_bound(size, link, m[1]) * 1e6


@pytest.mark.parametrize("name", BENCHES)
def test_analytic_rows_are_the_references_names_and_the_formulas(name, monkeypatch, capsys):
    ref = importlib.import_module(f"benchmarks.{name}")
    monkeypatch.setattr(ref, "run_with_devices", lambda *a, **k: "")
    ref.main()
    want = [r[0] for r in _rows(capsys.readouterr().out.strip())]
    importlib.import_module(f"repro_torch.benchmarks.{name}").analytic()
    got = _rows(capsys.readouterr().out)
    assert want and [r[0] for r in got] == want
    for row, us, _ in got:
        assert us == pytest.approx(_formula(row), abs=0.006), row
    assert name in prun.MODULES and name in prun.__doc__


def test_measured_rows_from_four_gloo_ranks():
    mods = [importlib.import_module(f"repro_torch.benchmarks.{n}") for n in BENCHES]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        outs = list(pool.map(lambda m: m.measured(4), mods))
    names = [[r[0] for r in _rows("\n".join(o))] for o in outs]
    assert names[0] == ["pingpong[dist=1]", "pingpong[dist=2]"]
    assert names[1] == [f"measured_podreduce[{2 ** k}B]" for k in (16, 20, 24)]
    assert names[2] == [f"measured_{op}[{axis},{2 ** k}B]" for op in ("psum", "all_gather")
                        for axis in ("model", "pod") for k in (16, 22)]
    for o in outs:
        assert all(us > 0 for _, us, _ in _rows("\n".join(o)))


def test_wire_bytes_agree():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute", "ragged-all-to-all"):
        for n in (1, 2, 3, 16, 256):
            assert wire_bytes(kind, 12345.0, n) == jax_wire_bytes(kind, 12345.0, n)


def test_whatif_table_is_the_reference_formula_on_the_ports_constants():
    """The reference's ``main`` body, its ``wire_bytes`` and its bundle's
    FLOPs, fed the port's chip and pod."""
    system = get_active_system()
    chip, pod_chips = system.chip, system.pod.num_chips
    cfg = jax_get_config("gemma3-27b")
    shape = JAX_SHAPES["train_4k"]
    grad_bytes = cfg.num_params() * 2.0
    t_compute = JaxBundle(cfg).model_flops(shape) / pod_chips / chip.peak_bf16_flops
    act_bytes = 2.0 * shape.global_batch * shape.seq_len * cfg.d_model
    got = whatif_scale.table("gemma3-27b")
    assert [r["pods"] for r in got] == [2, 4, 8, 16, 32, 64]
    for r in got:
        t_dcn = jax_wire_bytes("all-reduce", grad_bytes / pod_chips, r["pods"]) / chip.dcn_bandwidth
        t_pipe = act_bytes / pod_chips / chip.dcn_bandwidth
        assert r["chips"] == r["pods"] * pod_chips
        assert math.isclose(r["t_dcn"], t_dcn, rel_tol=1e-12)
        assert math.isclose(r["t_dcn_q"], t_dcn / 4.0, rel_tol=1e-12)
        assert math.isclose(r["t_pipe"], t_pipe, rel_tol=1e-12)
        assert math.isclose(r["t_compute"], t_compute, rel_tol=1e-12)
        assert r["verdict"] == ("compute-bound" if t_compute > max(t_dcn / 4.0, t_pipe)
                                else "compression sufficient" if t_dcn / 4.0 < t_compute
                                else "pipeline the pod axis")


def test_whatif_cli(capsys):
    whatif_scale.main(["--arch", "gemma3-27b"])
    out = capsys.readouterr().out
    assert out.startswith("gemma3-27b: 27.0B params") and out.count("compute-bound") == 6
