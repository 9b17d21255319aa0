"""The port's planner, model sizing and planner-driven benchmarks against
the JAX reference's, on the CPU.

* the reference's planner cases (``tests/test_planner.py``: predict
  against the datapath bounds, capacity pools, plan, the per-pool OOM
  report, donor gating) on the port's own H100 system;
* ``predict`` and ``plan`` equal the reference's field for field for every
  registered policy and the train, decode and prefill profiles of yi-6b,
  olmo-1b, granite-8b, mamba2-780m and gemma3-27b, both planners fed the
  same ``SystemSpec`` values (``port_system``), spec and calibrated;
* the sizing half of ``ModelBundle`` equals the reference's for every
  config the port's ``ModelBundle`` accepts (smoke and full), and
  ``ModelSizing``'s for every config whose cache the port describes;
* ``bench_llm_inference``: the serve leg's JSON has the reference's keys,
  the analytic leg's rows equal the reference's on the reference's spec;
  ``bench_datapath_bounds``' bound rows and policy table equal the
  reference's.
"""

import dataclasses
import json

import jax
import pytest

from repro.api import SPEC_SYSTEM as REF_SPEC
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import ShapeSpec as RefShape
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.core import placement as rP
from repro.core import planner as rPl
from repro.models.model_zoo import ModelBundle as RefBundle
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs, smoke_config
from repro_torch.core import hardware as pH
from repro_torch.core.datapath import collective_bound, copy_bound, read_bound
from repro_torch.core.hardware import Link, MemoryTier, get_active_system
from repro_torch.core.placement import (
    HBM_RESIDENT,
    KV_HOST,
    KV_PEER_HBM,
    KV_REMOTE_HBM,
    OPT_HOST,
    WEIGHTS_STREAM,
    DonorAxisError,
    Role,
    donor_allow_flags,
    registered_policies,
    validate_policy_for_mesh,
)
from repro_torch.core.planner import (
    _TIER_POOL,
    CollectiveTerm,
    PlacementOOMError,
    WorkloadProfile,
    eligible_policies,
    plan,
    pool_capacities,
    predict,
)
from repro_torch.models.model_zoo import ModelBundle, ModelSizing

from test_torch_datapath import REF_CAL, port_system

jax.config.update("jax_platform_name", "cpu")

GB = 1e9


def _kv_profile(kv_gb=1.0, param_gb=2.0, chunks=4, **kw):
    return WorkloadProfile(
        name="t",
        flops=1e12,
        bytes_per_role={Role.PARAMS: param_gb * GB, Role.KV_CACHE: kv_gb * GB},
        touches_per_role={Role.PARAMS: 1.0, Role.KV_CACHE: 1.0},
        stream_chunks=chunks,
        **kw,
    )


# ---------------------------------------------------------------------------
# the reference's planner cases, on the port's H100 system
# ---------------------------------------------------------------------------

class TestPredictMatchesDatapath:
    def test_hbm_resident_term_is_hbm_read_bound(self):
        p = predict(_kv_profile(), HBM_RESIDENT)
        b = read_bound(MemoryTier.HBM)
        assert p.hbm_s == pytest.approx(3.0 * GB / b.bandwidth + 2 * b.latency)
        assert p.pcie_s == 0.0 and p.ici_s == 0.0 and p.dcn_s == 0.0

    def test_streamed_host_term_is_copy_bound(self):
        chunks = 4
        p = predict(_kv_profile(chunks=chunks), KV_HOST)
        cb = copy_bound(MemoryTier.HOST, MemoryTier.HBM)
        assert cb.limiting_link == Link.PCIE
        assert p.pcie_s == pytest.approx(1.0 * GB / cb.bandwidth + chunks * cb.latency)
        hb = read_bound(MemoryTier.HBM)
        assert p.hbm_s == pytest.approx(3.0 * GB / hb.bandwidth + 2 * hb.latency)

    def test_shared_link_halving_inherited(self):
        assert copy_bound(MemoryTier.HOST, MemoryTier.HOST).bandwidth == (
            pytest.approx(read_bound(MemoryTier.HOST).bandwidth / 2))
        cb = copy_bound(MemoryTier.HOST, MemoryTier.HBM)
        sys_ = get_active_system()
        assert cb.bandwidth == pytest.approx(
            min(sys_.link_bandwidth(Link.PCIE), sys_.link_bandwidth(Link.HBM_BUS)))

    def test_peer_policy_bounded_by_ici(self):
        p = predict(_kv_profile(), KV_PEER_HBM)
        rb = read_bound(MemoryTier.PEER_HBM)
        assert rb.limiting_link == Link.ICI
        assert p.ici_s == pytest.approx(1.0 * GB / rb.bandwidth + rb.latency)
        assert 1.0 * GB / p.ici_s <= get_active_system().link_bandwidth(Link.ICI)

    def test_remote_policy_bounded_by_dcn(self):
        p = predict(_kv_profile(), KV_REMOTE_HBM)
        rb = read_bound(MemoryTier.REMOTE_HBM)
        assert rb.limiting_link == Link.DCN
        assert p.dcn_s == pytest.approx(1.0 * GB / rb.bandwidth + rb.latency)

    def test_collective_term_is_collective_bound(self):
        term = CollectiveTerm("all_reduce", Link.ICI, 16, 4 * GB)
        p = predict(_kv_profile(collectives=(term,)), HBM_RESIDENT)
        assert p.collective_s == pytest.approx(
            4 * GB / collective_bound(16, Link.ICI, "all_reduce"))


class TestCapacityPools:
    def test_staging_buffer_charged_to_hbm(self):
        p = predict(_kv_profile(chunks=4), KV_HOST)
        assert p.hbm_bytes == pytest.approx(2.0 * GB + 2 * GB / 4)
        assert p.host_bytes == pytest.approx(1.0 * GB)

    def test_dual_pool_overflow_detected(self):
        kv_gb = (pool_capacities()["host"] + GB) / GB
        p = predict(_kv_profile(kv_gb=kv_gb), KV_HOST)
        assert not p.fits and "host" in p.overflow_pools

    def test_peer_pool_overflow_detected(self):
        kv_gb = (pool_capacities()["peer_hbm"] + GB) / GB
        p = predict(_kv_profile(kv_gb=kv_gb), KV_PEER_HBM)
        assert not p.fits and "peer_hbm" in p.overflow_pools

    def test_all_tiers_have_pools(self):
        assert set(_TIER_POOL) == {t for t in MemoryTier if t != MemoryTier.VMEM}

    def test_h100_pools(self):
        caps = pool_capacities()
        assert caps["hbm"] == caps["peer_hbm"] == caps["remote_hbm"] == 80e9
        assert caps["host"] == caps["peer_host"] == 2e12 / 8


class TestPlan:
    def test_small_model_prefers_hbm(self):
        assert plan(_kv_profile())[0].policy == "hbm_resident"

    def test_oversized_kv_offloads(self):
        kv_gb = (pool_capacities()["hbm"] + GB) / GB
        best, preds = plan(_kv_profile(kv_gb=kv_gb, param_gb=1.0))
        assert best.policy != "hbm_resident" and best.fits
        assert "hbm_resident" in {p.policy for p in preds if not p.fits}

    def test_allow_flags_filter_tiers(self):
        names = {p.name for p in eligible_policies(allow_host=False)}
        assert "hbm_resident" in names
        assert not names & {"opt_host", "kv_host", "weights_stream", "opt_peer_host"}
        names = {p.name for p in eligible_policies(allow_peer=False)}
        assert not names & {"kv_peer_hbm", "weights_peer_hbm", "opt_peer_host"}
        assert "kv_remote_hbm" not in {
            p.name for p in eligible_policies(allow_remote=False)}
        with pytest.raises(ValueError, match="no eligible"):
            plan(_kv_profile(), policies=[])

    def test_plan_without_host_still_picks(self):
        kv_gb = (pool_capacities()["hbm"] + GB) / GB
        best, preds = plan(_kv_profile(kv_gb=kv_gb, param_gb=1.0), allow_host=False)
        assert best.policy in {"kv_peer_hbm", "kv_remote_hbm"}
        assert all(p.policy not in {"kv_host", "weights_stream", "opt_host"}
                   for p in preds)

    def test_offload_never_increases_hbm(self):
        for gb in (0.1, 1.0, 4.0, 8.0):
            prof = WorkloadProfile(
                name="t", flops=1e15,
                bytes_per_role={Role.PARAMS: gb * GB, Role.MASTER: 2 * gb * GB,
                                Role.OPT_STATE: 4 * gb * GB},
                touches_per_role={Role.PARAMS: 3, Role.MASTER: 2, Role.OPT_STATE: 2},
            )
            r = predict(prof, HBM_RESIDENT)
            assert predict(prof, OPT_HOST).hbm_bytes <= r.hbm_bytes
            assert predict(prof, WEIGHTS_STREAM).hbm_bytes <= r.hbm_bytes


class TestDonorGating:
    def test_one_card_plans_hbm_resident_only(self):
        flags = donor_allow_flags(None)
        assert flags == {"allow_host": False, "allow_peer": False, "allow_remote": False}
        best, preds = plan(_kv_profile(), **flags)
        assert [p.policy for p in preds] == ["hbm_resident"] == [best.policy]

    def test_plan_picks_peer_tier_under_donor_axes(self):
        kv_gb = (pool_capacities()["hbm"] - GB) / GB
        prof = _kv_profile(kv_gb=kv_gb, param_gb=2.0)
        best, _ = plan(prof, **donor_allow_flags({"donor": 2, "data": 2}))
        assert best.fits and best.policy in {"kv_peer_hbm", "weights_peer_hbm"}
        best, preds = plan(prof, **donor_allow_flags({"data": 4}))
        assert {p.policy for p in preds} == {"hbm_resident"} and not best.fits

    def test_validate_policy_for_mesh(self):
        validate_policy_for_mesh(HBM_RESIDENT, None)
        validate_policy_for_mesh(KV_PEER_HBM, {"donor": 2})
        validate_policy_for_mesh(KV_REMOTE_HBM, {"donor_pod": 2})
        with pytest.raises(DonorAxisError, match="donor"):
            validate_policy_for_mesh(KV_PEER_HBM, None)
        with pytest.raises(DonorAxisError, match="kv_cache"):
            validate_policy_for_mesh(KV_PEER_HBM, {"data": 4})
        with pytest.raises(DonorAxisError, match="donor_pod"):
            validate_policy_for_mesh(KV_REMOTE_HBM, {"donor": 2})


class TestPerPoolOOMReport:
    def test_overflow_lists_every_pool(self):
        caps = pool_capacities()
        prof = _kv_profile(kv_gb=(caps["peer_hbm"] + GB) / GB,
                           param_gb=(caps["hbm"] + GB) / GB)
        assert set(predict(prof, KV_PEER_HBM).overflow_pools) == {"hbm", "peer_hbm"}

    def test_require_fit_raises_with_per_pool_report(self):
        caps = pool_capacities()
        kv_gb = (caps["hbm"] + caps["host"] + GB) / GB
        with pytest.raises(PlacementOOMError) as exc:
            plan(_kv_profile(kv_gb=kv_gb, param_gb=1.0), require_fit=True)
        msg = str(exc.value)
        assert "hbm_resident" in msg and "hbm " in msg and "cap" in msg
        assert "kv_host" in msg and "host" in msg and exc.value.predictions


# ---------------------------------------------------------------------------
# parity with the reference planner, on the same SystemSpec values
# ---------------------------------------------------------------------------

PLANNER_ARCHS = ["yi-6b", "olmo-1b", "granite-8b", "mamba2-780m", "gemma3-27b"]
SYSTEMS = {"spec": (REF_SPEC, port_system(REF_SPEC)),
           "calibrated": (REF_CAL, port_system(REF_CAL))}
#: the serve shape chip_smoke.py uses, as the reference's Runtime builds it
SERVE = dict(max_len=2048, batch=8, chunk=256)


def _p_profile(p):
    """The reference's profile as the port's, with the port's enums."""
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    return WorkloadProfile(
        **fields | dict(
        bytes_per_role={Role(r.value): v for r, v in p.bytes_per_role.items()},
        touches_per_role={Role(r.value): v for r, v in p.touches_per_role.items()},
        collectives=tuple(CollectiveTerm(c.kind, Link(c.link.value), c.axis_size,
                                         c.payload_bytes) for c in p.collectives),
    ))


def _profiles(arch, num_chips):
    """(reference profile, port profile) per regime for ``arch``."""
    rb, pb = RefBundle(ref_get_config(arch)), ModelSizing(get_config(arch))
    rserve = RefShape("serve", SERVE["max_len"], SERVE["batch"], "decode")
    pserve = ShapeSpec("serve", SERVE["max_len"], SERVE["batch"], "decode")
    axes = dict(data_axis_size=16, pod_axis_size=2) if num_chips > 1 else {}
    return {
        "train": (rb.train_workload(REF_SHAPES["train_4k"], num_chips=num_chips, **axes),
                  pb.train_workload(SHAPES["train_4k"], num_chips=num_chips, **axes)),
        "decode": (rb.decode_workload(rserve, num_chips=num_chips),
                   pb.decode_workload(pserve, num_chips=num_chips)),
        "decode_32k": (rb.decode_workload(REF_SHAPES["decode_32k"], num_chips=num_chips),
                       pb.decode_workload(SHAPES["decode_32k"], num_chips=num_chips)),
        "prefill": (rb.prefill_workload(rserve, chunk_tokens=SERVE["chunk"],
                                        num_chips=num_chips),
                    pb.prefill_workload(pserve, chunk_tokens=SERVE["chunk"],
                                        num_chips=num_chips)),
    }


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("num_chips", [1, 256])
@pytest.mark.parametrize("arch", PLANNER_ARCHS)
def test_predict_and_plan_equal_reference(arch, num_chips, system):
    rsys, psys = SYSTEMS[system]
    for regime, (rprof, pprof) in _profiles(arch, num_chips).items():
        assert pprof == _p_profile(rprof), regime
        for name in rP.registered_policies():
            want = rPl.predict(rprof, rP.get_policy(name), rsys)
            got = predict(pprof, registered_policies()[name], psys)
            assert json.dumps(dataclasses.asdict(got), default=str) == \
                json.dumps(dataclasses.asdict(want), default=str), (regime, name)
            assert got.explain() == want.explain()
        for flags in ({}, {"allow_host": False}, {"allow_peer": False, "allow_remote": False},
                      {"allow_host": False, "allow_peer": False, "allow_remote": False}):
            rbest, rpreds = rPl.plan(rprof, None, rsys, **flags)
            pbest, ppreds = plan(pprof, None, psys, **flags)
            assert pbest.policy == rbest.policy, (regime, flags)
            assert [p.policy for p in ppreds] == [p.policy for p in rpreds]
            assert [p.step_s for p in ppreds] == [p.step_s for p in rpreds]


def test_oom_report_equals_reference():
    rsys, psys = SYSTEMS["spec"]
    rprof, pprof = _profiles("gemma3-27b", 1)["decode_32k"]
    with pytest.raises(rPl.PlacementOOMError) as rerr:
        rPl.plan(rprof, None, rsys, require_fit=True)
    with pytest.raises(PlacementOOMError) as perr:
        plan(pprof, None, psys, require_fit=True)
    assert str(perr.value) == str(rerr.value)
    assert pool_capacities(psys) == rPl.pool_capacities(rsys)


def _port_accepts(cfg) -> bool:
    try:
        ModelBundle(cfg)
    except NotImplementedError:
        return False
    return True


def _sizing_cases():
    cases = []
    for arch in list_archs():
        for smoke in (False, True):
            cfg = smoke_config(arch) if smoke else get_config(arch)
            if cfg.family == "audio":
                continue
            cases.append(pytest.param(arch, smoke, id=f"{arch}-{'smoke' if smoke else 'full'}"))
    return cases


@pytest.mark.parametrize("arch,smoke", _sizing_cases())
def test_sizing_equals_reference(arch, smoke):
    rcfg = ref_smoke_config(arch) if smoke else ref_get_config(arch)
    pcfg = smoke_config(arch) if smoke else get_config(arch)
    rb = RefBundle(rcfg)
    pb = ModelBundle(pcfg) if _port_accepts(pcfg) else ModelSizing(pcfg)
    for rshape, pshape in [(REF_SHAPES[k], SHAPES[k]) for k in REF_SHAPES] + [
            (RefShape("serve", 96, 4, "decode"), ShapeSpec("serve", 96, 4, "decode"))]:
        assert pb.decode_cache_len(pshape) == rb.decode_cache_len(rshape)
        assert pb.model_bytes(pshape) == rb.model_bytes(rshape)
        assert pb.cache_bytes(pshape) == rb.cache_bytes(rshape)
        assert pb.model_flops(pshape) == rb.model_flops(rshape)
        assert pb.train_workload(pshape, num_chips=4, data_axis_size=2, remat=False) \
            == _p_profile(rb.train_workload(rshape, num_chips=4, data_axis_size=2,
                                            remat=False))
        assert pb.decode_workload(pshape) == _p_profile(rb.decode_workload(rshape))
        assert pb.prefill_workload(pshape, chunk_tokens=32) == _p_profile(
            rb.prefill_workload(rshape, chunk_tokens=32))
        if isinstance(pb, ModelBundle):
            got = {k: (p.shape, p.dtype) for k, p in pb.input_defs(pshape).items()}
            want = {k: (p.shape, p.dtype) for k, p in rb.input_defs(rshape).items()}
            assert got == want
    assert pb.cache_bytes_for(3, 17) == rb.cache_bytes_for(3, 17)


def test_sizing_takes_what_the_bundle_refuses():
    cfg = get_config("gemma3-27b")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        ModelBundle(cfg)
    assert ModelSizing(cfg).cache_bytes(SHAPES["decode_32k"]) > 0
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ModelSizing(get_config("seamless-m4t-medium")).cache_bytes_for(1, 8)


# ---------------------------------------------------------------------------
# the planner-driven benchmarks
# ---------------------------------------------------------------------------

def _rows(text, prefixes=("",)):
    out = []
    for line in text.splitlines():
        if line.startswith(prefixes) and line and not line.startswith("#"):
            name, us, derived = line.rsplit(",", 2)
            out.append((name, float(us), derived))
    return out


@pytest.fixture
def tpu_valued_port():
    """The port's active system set to the reference's TPU values."""
    prev = pH.set_active_system(port_system(REF_SPEC))
    yield
    pH.set_active_system(prev)


def test_analytic_leg_equals_reference(capsys, tpu_valued_port):
    from benchmarks import bench_llm_inference as ref_bench
    from repro_torch.benchmarks import bench_llm_inference

    ref_bench.analytic()
    want = _rows(capsys.readouterr().out)
    got = bench_llm_inference.analytic()
    assert _rows(capsys.readouterr().out) == want
    assert [(n, round(us, 2), d) for n, us, d in got] == want
    assert len(want) == 3 * len(registered_policies())


def test_serve_leg_json_has_the_reference_keys(tmp_path, capsys):
    from benchmarks import bench_llm_inference as ref_bench
    from repro_torch.benchmarks import bench_llm_inference

    kw = dict(requests=2, prompt_len=6, max_new=2)
    want = ref_bench.serve(str(tmp_path / "ref.json"), **kw)
    got = bench_llm_inference.serve("cpu", tmp_path / "port.json", **kw)
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys(), key
        assert got[key]["policy"] == json.loads(rP.get_policy("hbm_resident").to_json())
        assert got[key]["mesh_axes"] is None
        assert set(got[key]["phases"]) == {"decode", "prefill"}
        for phase in got[key]["phases"].values():
            assert phase["picked"] == "hbm_resident"
            assert phase["top3"].startswith("phase=") and "limited by" in phase["top3"]
        assert got[key]["decode_tokens"] == want[key]["decode_tokens"] == 4
    rows = _rows(capsys.readouterr().out)
    assert sum(r[0].startswith("serve_") for r in rows) == 2 * 4


def _strip_spec(row):
    name, us, derived = row
    derived = derived.split(" spec=")[0].split("|spec_step=")[0]
    if "|spec_step=" in row[2]:
        derived += row[2][row[2].index("+"):] if "+" in row[2] else ""
    return name, us, derived


def test_datapath_bounds_rows_equal_reference(capsys, tpu_valued_port):
    from benchmarks import bench_datapath_bounds as ref_bench
    from repro_torch.benchmarks import bench_datapath_bounds

    table = ("bound_", "policy[")
    ref_bench.main()
    want = _rows(capsys.readouterr().out, table)
    bench_datapath_bounds.main("cpu")
    out = capsys.readouterr().out
    got = [_strip_spec(r) for r in _rows(out, table)]
    assert want and got == want
    names = [line.split(",")[0] for line in out.splitlines()]
    assert "peer_measured" in names and "policies" in names
