"""The port's hardware model and datapath bounds against the JAX reference's.

The port's ``SystemSpec`` is built from the reference's ``SPEC_SYSTEM``
field values (the TPU spec sheet); every bound, matrix, collective factor,
streaming time and crossover must then equal the reference's exactly.  The
provenance surface and the active-system registry mirror
``tests/test_calibration.py``; the H100 default's values are checked
against the data sheet.
"""

import dataclasses
import itertools
import warnings

import pytest

from repro.api import SPEC_SYSTEM as REF_SPEC
from repro.core import datapath as rD
from repro.core import hardware as rH
from repro_torch.core import datapath as pD
from repro_torch.core import hardware as pH
from repro_torch.core import warnings_registry


def port_system(ref_sys: rH.SystemSpec) -> pH.SystemSpec:
    """The port's SystemSpec with the reference system's field values."""
    rc = ref_sys.chip
    chip = pH.ChipSpec(**{f.name: getattr(rc, f.name)
                          for f in dataclasses.fields(rH.ChipSpec)})
    pod = pH.PodSpec(chip=chip, mesh_shape=ref_sys.pod.mesh_shape,
                     torus_wraparound=ref_sys.pod.torus_wraparound)
    return pH.SystemSpec(pod=pod, num_pods=ref_sys.num_pods,
                         provenance=dict(ref_sys.provenance))


REF = REF_SPEC
PORT = port_system(REF)
#: a calibrated pair: the same measured terms on both sides
REF_CAL = REF.with_measurements(hbm_bandwidth=700e9, pcie_bandwidth=20e9,
                                hbm_latency=2e-6, ici_link_bandwidth=40e9)
PORT_CAL = port_system(REF_CAL)
SYSTEMS = [(REF, PORT), (REF_CAL, PORT_CAL)]
TIERS = list(rH.MemoryTier)
NON_VMEM = [t for t in TIERS if t != rH.MemoryTier.VMEM]


def _p(tier: rH.MemoryTier) -> pH.MemoryTier:
    return pH.MemoryTier(tier.value)


def _same_bound(r: rD.Bound, p: pD.Bound) -> None:
    assert p.bandwidth == r.bandwidth
    assert p.latency == r.latency
    assert p.limiting_link.value == r.limiting_link.value
    assert [(l.value, n) for l, n in p.traversals] == [
        (l.value, n) for l, n in r.traversals]


def test_names_are_one_to_one():
    for rc, pc in ((rH.ChipSpec, pH.ChipSpec), (rH.PodSpec, pH.PodSpec),
                   (rH.SystemSpec, pH.SystemSpec)):
        assert [f.name for f in dataclasses.fields(pc)] == [
            f.name for f in dataclasses.fields(rc)]
    assert [t.value for t in pH.MemoryTier] == [t.value for t in rH.MemoryTier]
    assert [l.value for l in pH.Link] == [l.value for l in rH.Link]
    assert pH.CALIBRATED_TERMS == rH.CALIBRATED_TERMS
    assert pH.PROVENANCES == rH.PROVENANCES
    assert {a: l.value for a, l in pH.AXIS_LINK.items()} == {
        a: l.value for a, l in rH.AXIS_LINK.items()}


@pytest.mark.parametrize("si", range(len(SYSTEMS)), ids=["spec", "calibrated"])
@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_read_write_bounds_equal(si, tier):
    r, p = SYSTEMS[si]
    _same_bound(rD.read_bound(tier, r), pD.read_bound(_p(tier), p))
    _same_bound(rD.write_bound(tier, r), pD.write_bound(_p(tier), p))
    assert [l.value for l in pD.path(_p(tier))] == [l.value for l in rD.path(tier)]
    for link in rH.Link:
        assert p.link_bandwidth(pH.Link(link.value)) == r.link_bandwidth(link)
        assert p.link_latency(pH.Link(link.value)) == r.link_latency(link)


@pytest.mark.parametrize("si", range(len(SYSTEMS)), ids=["spec", "calibrated"])
@pytest.mark.parametrize("src,dst", list(itertools.product(TIERS, TIERS)),
                         ids=lambda t: str(t))
def test_copy_bounds_equal(si, src, dst):
    r, p = SYSTEMS[si]
    _same_bound(rD.copy_bound(src, dst, r), pD.copy_bound(_p(src), _p(dst), p))


@pytest.mark.parametrize("op", ["read", "write", "copy"])
def test_bound_matrix_equal(op):
    for r, p in SYSTEMS:
        assert pD.bound_matrix(op, system=p) == rD.bound_matrix(op, system=r)
        sub = [rH.MemoryTier.HBM, rH.MemoryTier.HOST]
        assert pD.bound_matrix(op, [_p(t) for t in sub], p) == rD.bound_matrix(op, sub, r)
    with pytest.raises(ValueError):
        pD.bound_matrix("move", system=PORT)


@pytest.mark.parametrize("kind", ["all_reduce", "all_gather", "reduce_scatter",
                                  "all_to_all", "collective_permute"])
def test_collective_bound_equal(kind):
    for r, p in SYSTEMS:
        for link, n in itertools.product(rH.Link, range(1, 17)):
            assert pD.collective_bound(n, pH.Link(link.value), kind, p) == \
                rD.collective_bound(n, link, kind, r)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute",
                                  "ragged-all-to-all"])
def test_wire_bytes_equal(kind):
    for n in range(0, 17):
        for payload in (0.0, 1.0, 12345.0, 2.0**30):
            assert pD.wire_bytes(kind, payload, n) == rD.wire_bytes(kind, payload, n)


@pytest.mark.parametrize("tier", NON_VMEM, ids=str)
def test_streaming_time_and_crossover_equal(tier):
    for r, p in SYSTEMS:
        for touches in (1, 4, 16, 64, 256):
            for nbytes in (1.0, 2.0**20, 2.0**30):
                assert pD.streaming_time(nbytes, _p(tier), p, touches=touches) == \
                    rD.streaming_time(nbytes, tier, r, touches=touches)
        assert pD.migration_crossover_touches(_p(tier), p) == \
            rD.migration_crossover_touches(tier, r)


def test_pod_geometry_equal():
    for shape, wrap in (((16, 16), True), ((4, 8), False), ((1,), False)):
        rp = rH.PodSpec(mesh_shape=shape, torus_wraparound=wrap)
        pp = pH.PodSpec(chip=PORT.chip, mesh_shape=shape, torus_wraparound=wrap)
        assert pp.num_chips == rp.num_chips
        assert pp.bisection_bandwidth() == rp.bisection_bandwidth()
        for a, b in itertools.product(itertools.product(*[range(min(s, 3)) for s in shape]),
                                      repeat=2):
            assert pp.ici_hops(a, b) == rp.ici_hops(a, b)
    assert PORT.num_chips == REF.num_chips


# -- the H100 default --------------------------------------------------------

def test_h100_default_is_the_data_sheet():
    c = pH.SPEC_SYSTEM.chip
    assert c.name == "h100-sxm5-80gb"
    assert c.peak_bf16_flops == 989e12
    assert c.peak_flops_by_dtype == {"bfloat16": 989e12, "float32": 67e12,
                                     "int8": 1979e12}
    assert c.hbm_bandwidth == 3.35e12 and c.hbm_capacity == 80e9
    assert c.pcie_bandwidth == 64e9
    assert c.vmem_capacity == 232_448
    assert c.ici_link_bandwidth == 450e9
    assert pH.SPEC_SYSTEM.pod.mesh_shape == (1,)
    assert pH.SPEC_SYSTEM.num_pods == 1 and pH.SPEC_SYSTEM.num_chips == 1
    for term, d in pH.SPEC_SYSTEM.describe_terms().items():
        assert d["provenance"] == "spec", term
        assert d["value"] > 0
    # the card's two real tiers: HBM at 3.35 TB/s, host memory over PCIe
    assert pD.read_bound(pH.MemoryTier.HBM).bandwidth == 3.35e12
    b = pD.read_bound(pH.MemoryTier.HOST)
    assert b.bandwidth == 64e9 and b.limiting_link == pH.Link.PCIE
    assert pD.copy_bound(pH.MemoryTier.HOST, pH.MemoryTier.HOST).bandwidth == 32e9


# -- provenance (mirrors tests/test_calibration.py::TestProvenance) -----------

class TestProvenance:
    def test_every_term_defaults_to_spec(self):
        sys_ = pH.SystemSpec()
        for term in pH.CALIBRATED_TERMS:
            assert sys_.provenance_of(term) == "spec", term
            assert sys_.term_value(term) > 0

    def test_with_measurements_marks_measured(self):
        base = pH.SystemSpec()
        cal = base.with_measurements(hbm_bandwidth=100e9, hbm_latency=2e-6)
        assert cal.provenance_of("hbm_bandwidth") == "measured"
        assert cal.provenance_of("hbm_latency") == "measured"
        assert cal.term_value("hbm_bandwidth") == 100e9
        assert cal.chip.hbm_bandwidth == 100e9
        assert cal.provenance_of("ici_link_bandwidth") == "spec"
        assert cal.term_value("pcie_bandwidth") == base.term_value("pcie_bandwidth")

    def test_with_overrides_marks_override(self):
        cal = pH.SystemSpec().with_overrides(dcn_bandwidth=5e9)
        assert cal.provenance_of("dcn_bandwidth") == "override"
        assert cal.term_value("dcn_bandwidth") == 5e9

    def test_original_system_is_untouched(self):
        base = pH.SystemSpec()
        before = base.term_value("hbm_bandwidth")
        base.with_measurements(hbm_bandwidth=1e9)
        assert base.term_value("hbm_bandwidth") == before
        assert base.provenance_of("hbm_bandwidth") == "spec"

    def test_unknown_term_raises_keyerror(self):
        with pytest.raises(KeyError, match="unknown calibratable term"):
            pH.SystemSpec().with_measurements(warp_core_bandwidth=1.0)
        with pytest.raises(KeyError):
            pH.SystemSpec().provenance_of("warp_core_bandwidth")

    def test_non_positive_measurement_raises(self):
        with pytest.raises(ValueError):
            pH.SystemSpec().with_measurements(hbm_bandwidth=0.0)
        with pytest.raises(ValueError):
            pH.SystemSpec().with_measurements(hbm_latency=-1e-6)

    def test_chained_derivations_accumulate(self):
        cal = (pH.SystemSpec()
               .with_measurements(hbm_bandwidth=100e9)
               .with_overrides(ici_link_bandwidth=10e9))
        assert cal.provenance_of("hbm_bandwidth") == "measured"
        assert cal.provenance_of("ici_link_bandwidth") == "override"
        assert cal.term_value("hbm_bandwidth") == 100e9

    def test_derivations_match_the_reference(self):
        r = REF.with_measurements(pcie_bandwidth=9e9).with_overrides(dcn_latency=3e-6)
        p = PORT.with_measurements(pcie_bandwidth=9e9).with_overrides(dcn_latency=3e-6)
        assert p.describe_terms() == r.describe_terms()
        assert dict(p.provenance) == dict(r.provenance)


class TestActiveSystem:
    def test_default_active_system_is_the_spec_sheet(self):
        assert pH.get_active_system() is pH.SPEC_SYSTEM

    def test_set_returns_previous_and_installs(self):
        cal = pH.SPEC_SYSTEM.with_measurements(hbm_bandwidth=50e9)
        prev = pH.set_active_system(cal)
        try:
            assert prev is pH.SPEC_SYSTEM
            assert pH.get_active_system() is cal
        finally:
            pH.set_active_system(prev)
        assert pH.get_active_system() is pH.SPEC_SYSTEM

    def test_set_rejects_non_system(self):
        with pytest.raises(TypeError):
            pH.set_active_system("3.35TB/s")
        with pytest.raises(TypeError):
            pH.set_active_system(REF)

    def test_datapath_defaults_resolve_to_active_system(self):
        base = pD.read_bound(pH.MemoryTier.HBM).bandwidth
        prev = pH.set_active_system(
            pH.SPEC_SYSTEM.with_measurements(hbm_bandwidth=base / 4))
        try:
            assert pD.read_bound(pH.MemoryTier.HBM).bandwidth == base / 4
        finally:
            pH.set_active_system(prev)
        assert pD.read_bound(pH.MemoryTier.HBM).bandwidth == base


class TestAxisLinks:
    def test_donor_axes_are_mapped(self):
        assert pH.link_for_axis("donor", strict=True) == pH.Link.ICI
        assert pH.link_for_axis("donor_pod", strict=True) == pH.Link.DCN
        assert pH.link_for_axis("pod", strict=True) == pH.Link.DCN

    def test_unknown_axis_warns_once_then_falls_back_to_ici(self):
        warnings_registry.reset_warnings()
        with pytest.warns(UserWarning, match="no AXIS_LINK entry"):
            assert pH.link_for_axis("mystery") == pH.Link.ICI
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert pH.link_for_axis("mystery") == pH.Link.ICI
        warnings_registry.reset_warnings()

    def test_unknown_axis_raises_when_strict(self):
        with pytest.raises(KeyError, match="AXIS_LINK"):
            pH.link_for_axis("mystery", strict=True)

    def test_axis_bandwidth_prices_under_given_system(self):
        sys_ = pH.SPEC_SYSTEM.with_overrides(dcn_bandwidth=7e9)
        assert pH.axis_bandwidth("pod", sys_) == 7e9
        assert pH.axis_bandwidth("model") == 450e9
        assert pH.axis_bandwidth("model", PORT) == rH.axis_bandwidth("model", REF)
