"""The port's measurement harness, replay log and calibration against the
JAX reference's, on the CPU.

``linear_fit``, ``Measurement.csv``, ``ReplayLog`` (aggregates, gate, JSON)
and ``calibration.json`` are held to the reference's on the same inputs; a
file either package saves loads in the other with equal terms.  A real
(tiny) ``calibrate(device="cpu")`` measures the HBM term only and leaves
PCIe, NVLink and InfiniBand at ``spec``, as the reference does on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import calibration as rcal
from repro.core import membench as rmb
from repro.core import replay as rrep
from repro.api import SPEC_SYSTEM as REF_SYSTEM
from repro_torch.core import calibration as pcal
from repro_torch.core import hardware as pH
from repro_torch.core import membench as pmb
from repro_torch.core import replay as prep


def _meas(mod, nbytes, mean_s, name="m"):
    return mod.Measurement(name=name, mean_s=mean_s, min_s=mean_s,
                           max_s=mean_s, std_s=0.0, repeats=1,
                           nbytes=float(nbytes))


def _sweeps():
    rng = np.random.default_rng(0)
    out = [
        [(n, 5e-6 + n / 200e9) for n in (2**16, 2**20, 2**24)],   # exact line
        [(2**20, 1e-3)],                                            # one point
        [(2**16, 1e-6), (2**20, 6e-5)],                             # intercept < 0
        [(2**16, 1e-3), (2**20, 1e-4)],                             # slope < 0
        [(2**20, 1e-3), (2**20, 2e-3)],                             # one size twice
        [(0, 1e-3), (2**20, 2e-3)],                                 # nbytes 0 dropped
    ]
    for _ in range(4):                                              # noisy sweeps
        sizes = sorted(int(s) for s in rng.integers(2**12, 2**28, size=5))
        out.append([(s, abs(rng.normal(1e-5, 5e-6)) + s / rng.uniform(1e9, 3e12))
                    for s in sizes])
    return out


@pytest.mark.parametrize("i", range(10))
def test_linear_fit_equals_reference(i):
    pts = _sweeps()[i]
    got = pmb.linear_fit([_meas(pmb, n, t) for n, t in pts])
    want = rmb.linear_fit([_meas(rmb, n, t) for n, t in pts])
    assert got == want


def test_linear_fit_needs_bytes():
    for mod in (pmb, rmb):
        with pytest.raises(ValueError, match="nbytes"):
            mod.linear_fit([_meas(mod, 0, 1e-3)])


def test_measurement_rows_equal_reference():
    for kw in (dict(nbytes=2**20), dict(flops=2.0 * 512**3), dict()):
        r = rmb.Measurement("x[1]", 1.5e-4, 1e-4, 2e-4, 3e-5, 10, **kw)
        p = pmb.Measurement("x[1]", 1.5e-4, 1e-4, 2e-4, 3e-5, 10, **kw)
        assert p.csv() == r.csv() and p.csv("d") == r.csv("d")
        assert (p.bandwidth, p.gbps, p.tflops, p.us_per_call) == (
            r.bandwidth, r.gbps, r.tflops, r.us_per_call)


def test_measure_on_cpu_and_default_device():
    calls = []
    m = pmb.measure(lambda: calls.append(1), name="noop", warmup=2, repeats=3,
                    nbytes=64, device="cpu")
    assert len(calls) == 5 and m.repeats == 3 and m.name == "noop"
    assert 0 <= m.min_s <= m.mean_s <= m.max_s
    sweep = pmb.sweep(lambda n: (lambda: torch.ones(n).sum()), [16, 64],
                      name="ones", repeats=2, device="cpu")
    assert [s.name for s in sweep] == ["ones[16]", "ones[64]"]
    assert pmb.dispatch_overhead(5, device="cpu") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmb.measure(lambda: None)      # the default is the card


def _fill(log):
    log.record("hbm_bandwidth", "read[1MB]", 1e-3, 2e-3,
               nbytes=2**20, limiting_link="hbm_bus", source="test")
    log.record("hbm_bandwidth", "read[16MB]", 1.0e-2, 1.1e-2,
               nbytes=2**24, limiting_link="hbm_bus", source="test")
    log.record("pcie_bandwidth", "read[pinned,1MB]", 3e-5, 2e-5,
               nbytes=2**20, limiting_link="pcie", source="test")
    log.record("t", "bad", 1e-3, 0.0)                      # dropped
    for i in range(300):                                    # past the cap
        log.record("dcn_bandwidth", f"p{i}", 2.0, 1.0 + i / 300)
    return log


def test_replay_log_equals_reference():
    r, p = _fill(rrep.ReplayLog()), _fill(prep.ReplayLog())
    assert len(p) == len(r)
    assert p.terms == r.terms
    assert p.report() == r.report()
    assert p.to_json() == r.to_json()
    for thr, per in ((1.0, None), (0.2, None), (1.0, {"dcn_bandwidth": 0.1}),
                     (0.0, {"hbm_bandwidth": 5.0})):
        assert p.gate(thr, per) == r.gate(thr, per)
    back = prep.ReplayLog.from_json(json.loads(json.dumps(r.to_json())))
    assert back.to_json() == r.to_json()
    assert prep.ReplayLog().report() == rrep.ReplayLog().report()


def _cal(mod_cal, spec):
    cal = mod_cal.Calibration(backend="cuda", num_devices=1,
                              created="2026-10-17T00:00:00")
    cal.terms["hbm_bandwidth"] = mod_cal.TermCalibration(
        term="hbm_bandwidth", spec=spec, measured=2.9e12, unit="B/s",
        source="bench_membw.read[device]", detail="sizes=[268435456]")
    cal.terms["pcie_latency"] = mod_cal.TermCalibration(
        term="pcie_latency", spec=1e-6, measured=4.2e-6, unit="s",
        source="bench_membw.read[pinned_host]")
    _fill(cal.replay)
    return cal


def test_calibration_json_interchange_both_ways(tmp_path):
    ref_cal = _cal(rcal, 819e9)
    port_cal = _cal(pcal, 3.35e12)
    # reference -> port
    path = ref_cal.save(tmp_path / "ref.json")
    loaded = pcal.Calibration.load(path)
    assert loaded.to_json() == ref_cal.to_json()
    assert {t: c.to_json() for t, c in loaded.terms.items()} == {
        t: c.to_json() for t, c in ref_cal.terms.items()}
    sys_ = loaded.apply(pH.SPEC_SYSTEM)
    assert sys_.term_value("hbm_bandwidth") == 2.9e12
    assert sys_.provenance_of("pcie_latency") == "measured"
    assert sys_.provenance_of("ici_link_bandwidth") == "spec"
    # port -> reference
    path = port_cal.save(tmp_path / "port.json")
    assert json.loads(path.read_text())["format_version"] == 1
    back = rcal.Calibration.load(path)
    assert back.to_json() == port_cal.to_json()
    assert back.apply(REF_SYSTEM).term_value("hbm_bandwidth") == 2.9e12
    assert port_cal.summary().splitlines()[1:] == back.summary().splitlines()[1:]
    with pytest.raises(ValueError, match="newer"):
        pcal.Calibration.from_json({"format_version": 99})


class TestCalibrateOnCpu:
    @pytest.fixture(scope="class")
    def cal(self):
        return pcal.calibrate(sizes=(2**14, 2**17), repeats=2, device="cpu")

    def test_measures_hbm_only_and_replays(self, cal):
        assert cal.backend == "cpu" and cal.num_devices == 1
        assert "hbm_bandwidth" in cal.terms
        assert cal.terms["hbm_bandwidth"].measured > 0
        assert cal.terms["hbm_bandwidth"].spec == 3.35e12
        assert not any(t.startswith(("pcie", "ici", "dcn")) for t in cal.terms)
        assert set(cal.replay.terms) == {"hbm_bandwidth"}
        assert len(cal.replay) == 2
        sys_ = cal.apply(pH.SPEC_SYSTEM)
        assert sys_.provenance_of("hbm_bandwidth") == "measured"
        for term in ("pcie_bandwidth", "pcie_latency", "ici_link_bandwidth",
                     "dcn_bandwidth"):
            assert sys_.provenance_of(term) == "spec"
        assert "spec provenance kept for" in cal.summary()
        assert "pcie_bandwidth" in cal.summary().splitlines()[-1]

    def test_load_or_calibrate_round_trip(self, cal, tmp_path):
        path = tmp_path / "calibration.json"
        cal.save(path)
        loaded = pcal.load_or_calibrate(path)
        assert set(loaded.terms) == set(cal.terms)
        assert pH.get_active_system() is pH.SPEC_SYSTEM
        prev = pH.get_active_system()
        try:
            pcal.load_or_calibrate(path, activate=True)
            assert pH.get_active_system().provenance_of("hbm_bandwidth") == "measured"
        finally:
            pH.set_active_system(prev)

    def test_default_sizes(self):
        assert pcal.DEFAULT_SIZES == rcal.DEFAULT_SIZES
        assert min(pcal.CUDA_SIZES) >= 256 * 2**20 > 50 * 2**20   # past L2
        assert pcal.host_available("cpu") is False
