"""The port's ``Runtime`` against the reference's, on the CPU.

The reference's ``Runtime`` runs over a one-device mesh
(``make_mesh_for((1,), ("data",))``), the port's over the CPU device; both
are fed the same ``SystemSpec`` values (the reference's, spec and
calibrated, ``port_system``) and the same tier eligibility (``_allow_flags``
set on both: this JAX's CPU backend reports a pinned-host memory kind, so
the reference's own flags allow host tiers where the port's CPU has none):

* ``plan_phase`` picks, scores, feasibility and prediction tables for the
  train, decode, prefill and serve phases, with no far tier (only
  ``hbm_resident``) and with host tiers allowed (what a card realizes);
* ``price_copy``, ``spill_placement``, ``preemption_price``;
* ``decode_step_seconds`` before and after observations (EWMA 0.8/0.2),
  and the replay log they feed;
* ``DonorAxisError`` for peer/remote policies on one device;
* ``migrate`` / ``migrate_roles``: value-exact round trips between the
  device and host memory, the adopted policy names, and the name left by
  a partial failure;
* ``HostStream``: window order, what is held (never more than ``depth``
  windows), depth 2 over 1 window and over ``n_windows``, write-back, and
  the stream a migration rebuilds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import Runtime as RefRuntime
from repro.configs import get_config as ref_get_config
from repro.core.hardware import MemoryTier as RefTier
from repro.core.placement import DonorAxisError as RefDonorAxisError
from repro.core.placement import Placement as RefPlacement
from repro.launch.mesh import make_mesh_for
from repro.models.model_zoo import ModelBundle as RefBundle
from repro_torch.api import Runtime
from repro_torch.configs import get_config
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import (
    DonorAxisError,
    HostStream,
    Placement,
    Role,
    Strategy,
    donor_allow_flags,
    host_available,
    registered_policies,
)
from repro_torch.models.model_zoo import ModelBundle, ModelSizing
from repro_torch.models.sharding import tree_leaves, tree_map

from test_torch_datapath import PORT, PORT_CAL, REF, REF_CAL

jax.config.update("jax_platform_name", "cpu")

SYSTEMS = [(REF, PORT), (REF_CAL, PORT_CAL)]
NO_FAR_TIER = {"allow_host": False, "allow_peer": False, "allow_remote": False}
HOST_ALLOWED = {"allow_host": True, "allow_peer": False, "allow_remote": False}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh_for((1,), ("data",))


def _pair(arch, mesh, ref_sys, port_sys, policy=None, allow_host=False):
    ref = RefRuntime(RefBundle(ref_get_config(arch)), mesh, policy, system=ref_sys)
    port = Runtime(ModelSizing(get_config(arch)), "cpu", policy, system=port_sys)
    flags = HOST_ALLOWED if allow_host else NO_FAR_TIER
    ref._allow_flags = port._allow_flags = lambda: dict(flags)
    return ref, port


def _same_plan(ref, port, phase):
    r, p = ref.plans[phase], port.plans[phase]
    assert p.picked == r.picked
    assert p.score == r.score
    assert p.feasible == r.feasible
    assert {k: v.explain() for k, v in p.predictions.items()} == {
        k: v.explain() for k, v in r.predictions.items()}
    assert port.explain(phase) == ref.explain(phase)
    assert port.policy.name == ref.policy.name


PHASES = [
    ("train", dict(batch=4, seq=2048)),
    ("decode", dict(batch_slots=8, max_len=2048)),
    ("prefill", dict(batch_slots=8, max_len=2048, prefill_chunk=256)),
    ("serve", dict(batch_slots=8, max_len=2048, prefill_chunk=256)),
    # a cache far past the HBM pool: the picks leave HBM
    ("decode", dict(batch_slots=256, max_len=32768)),
    ("serve", dict(batch_slots=256, max_len=32768, prefill_chunk=256)),
]


@pytest.mark.parametrize("systems", [0, 1], ids=["spec", "calibrated"])
@pytest.mark.parametrize("allow_host", [False, True], ids=["cpu_tiers", "host"])
@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b"])
@pytest.mark.parametrize("phase,kw", PHASES, ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}{x}" for k, x in v.items()))
def test_plan_phase_equals_reference(mesh, systems, allow_host, arch, phase, kw):
    ref, port = _pair(arch, mesh, *SYSTEMS[systems], allow_host=allow_host)
    rp = ref.plan_phase(phase, candidates=list(registered_policies()), **kw)
    pp = port.plan_phase(phase, candidates=list(registered_policies()), **kw)
    assert pp.explain() == rp.explain()
    _same_plan(ref, port, phase)
    if not allow_host:
        assert port.policy.name == "hbm_resident"


def test_auto_on_the_cpu_picks_hbm_resident_and_describes_itself():
    rt = Runtime.auto(ModelSizing(get_config("yi-6b")), "cpu", phase="serve",
                      batch_slots=256, max_len=32768, prefill_chunk=256)
    assert rt.policy.name == "hbm_resident"
    assert set(rt.plans["serve"].predictions) == {"hbm_resident"}
    d = rt.describe()
    assert d["policy"]["name"] == "hbm_resident" and d["mesh_axes"] is None
    assert d["device"] == "cpu" and d["phases"]["serve"]["picked"] == "hbm_resident"
    assert Runtime(ModelSizing(get_config("yi-6b")), "cpu", "kv_host").explain() == ""


def test_host_tier_follows_the_device():
    assert not host_available("cpu") and host_available("cuda")
    assert not host_available(None)
    assert donor_allow_flags(None, "cuda") == {
        "allow_host": True, "allow_peer": False, "allow_remote": False}
    assert donor_allow_flags(None, "cpu")["allow_host"] is False
    assert donor_allow_flags({"donor": 2}, "cpu")["allow_peer"] is True


@pytest.mark.parametrize("systems", [0, 1], ids=["spec", "calibrated"])
@pytest.mark.parametrize("allow_host", [False, True], ids=["cpu_tiers", "host"])
@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "weights_stream"])
def test_pricing_equals_reference(mesh, systems, allow_host, policy):
    ref, port = _pair("yi-6b", mesh, *SYSTEMS[systems], policy=policy,
                      allow_host=allow_host)
    for nbytes in (1, 1 << 20, 1.07e9):
        for dst in ("hbm", "host", "peer_hbm", "remote_hbm"):
            assert port.price_copy(nbytes, dst) == ref.price_copy(nbytes, dst)
            assert port.price_copy(nbytes, dst, src="host") == \
                ref.price_copy(nbytes, dst, src="host")
        assert port.price_copy(nbytes, Placement(MemoryTier.HOST, Strategy.STREAM)) \
            == ref.price_copy(nbytes, "host")
        rspill, rs = ref.preemption_price(nbytes)
        pspill, ps = port.preemption_price(nbytes)
        assert pspill.to_str() == rspill.to_str() and ps == rs
    assert port.spill_placement().to_str() == ref.spill_placement().to_str()
    assert port.spill_placement().tier is (MemoryTier.HOST if allow_host else MemoryTier.HBM)


@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "weights_stream"])
def test_decode_step_seconds_before_and_after_observations(mesh, policy):
    ref, port = _pair("yi-6b", mesh, REF, PORT, policy=policy)
    assert port.decode_step_seconds(8, 2048) == ref.decode_step_seconds(8, 2048)
    assert port.measured_step_s(8, 2048) is None
    for s in (0.03, 0.01, 0.0, 0.05):
        assert port.observe_decode_step(8, 2048, s) == pytest.approx(
            ref.observe_decode_step(8, 2048, s), rel=0, abs=0)
    assert port.measured_step_s(8, 2048) == ref.measured_step_s(8, 2048)
    ewma = 0.03
    for s in (0.01, 0.05):
        ewma = 0.8 * ewma + 0.2 * s
    assert port.decode_step_seconds(8, 2048) == pytest.approx(ewma)
    assert port.measured_step_s(4, 2048) is None        # keyed by shape
    assert len(port.replay) == len(ref.replay) == 3     # the 0.0 is skipped
    assert [r.predicted_s for r in port.replay.records()] == [
        r.predicted_s for r in ref.replay.records()]


@pytest.mark.parametrize("policy", ["kv_peer_hbm", "weights_peer_hbm", "opt_peer_host",
                                    "kv_remote_hbm", "kv=peer_host:stream"])
def test_donor_policies_raise_on_one_device(mesh, policy):
    with pytest.raises(RefDonorAxisError):
        RefRuntime(RefBundle(ref_get_config("yi-6b")), mesh, policy)
    with pytest.raises(DonorAxisError):
        Runtime(ModelSizing(get_config("yi-6b")), "cpu", policy)
    rt = Runtime(ModelSizing(get_config("yi-6b")), "cpu")
    with pytest.raises(DonorAxisError):
        rt.migrate({"k": torch.zeros(2)}, "kv", policy)
    assert rt.policy.name == "hbm_resident"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"stages": [{"0F": {"k": torch.randn(2, 3, 4, 8, generator=g),
                               "v": torch.randn(2, 3, 4, 8, generator=g)}}],
            "b": torch.randn(5, generator=g).to(torch.bfloat16)}


def _jtree(tree):
    return tree_map(lambda t: np.asarray(t.float()), tree)


def test_migrate_round_trip_is_value_exact_and_names_match(mesh):
    ref, port = _pair("yi-6b", mesh, REF, PORT)
    tree = _tree()
    jtree = _jtree(tree)
    host = port.migrate(tree, "kv", "kv_host")
    jhost = ref.migrate(jtree, "kv", "kv_host")
    assert port.policy.name == ref.policy.name == "kv_host"
    for a, b in zip(tree_leaves(tree), tree_leaves(host)):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.data_ptr() != b.data_ptr() and b._host_arena is not None
    back = port.migrate(host, "kv", Placement(MemoryTier.HBM))
    jback = ref.migrate(jhost, "kv", RefPlacement(RefTier.HBM))
    assert port.policy.name == ref.policy.name
    assert port.policy.placement(Role.KV_CACHE) == Placement()
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert torch.equal(a, b)
    same = tree_map(lambda a, b: np.array_equal(a, np.asarray(b)), jtree, jback)
    assert all(tree_leaves(same))


def test_migrate_roles_moves_changed_roles_and_names_partial_failure(mesh):
    ref, port = _pair("yi-6b", mesh, REF, PORT)
    target = "kv=host:stream,opt=host:stream"
    trees = {Role.KV_CACHE: _tree(1), Role.OPT_STATE: _tree(2)}
    moved = port.migrate_roles(trees, target)
    rmoved = ref.migrate_roles(
        {Role.KV_CACHE: _jtree(_tree(1)), Role.OPT_STATE: _jtree(_tree(2))}, target)
    assert [r.value for r in moved] == [r.value for r in rmoved] == ["kv_cache", "opt_state"]
    assert port.policy.name == ref.policy.name
    assert all(t._host_arena is not None for t in tree_leaves(trees))
    assert port.migrate_roles(trees, target) == []       # nothing changed
    # a tree that cannot move fails after the first role landed
    ref, port = _pair("yi-6b", mesh, REF, PORT)
    bad = {Role.KV_CACHE: _tree(1), Role.OPT_STATE: {"w": "not a tensor"}}
    jbad = {Role.KV_CACHE: _jtree(_tree(1)), Role.OPT_STATE: {"w": "not a tensor"}}
    with pytest.raises((AttributeError, TypeError)):
        port.migrate_roles(bad, target)
    with pytest.raises((AttributeError, TypeError)):
        ref.migrate_roles(jbad, target)
    assert port.policy.name == ref.policy.name == "hbm_resident+kv_cache=host:stream"
    assert bad[Role.KV_CACHE]["b"]._host_arena is not None   # the moved role survives


def test_realize_and_streamed():
    rt = Runtime(ModelSizing(get_config("yi-6b")), "cpu", "kv_host")
    tree = _tree()
    assert rt.realize(tree, "params") is tree                # already on the device
    host = rt.realize(tree, "kv")
    assert host is not tree and rt.realize(host, "kv") is host
    assert rt.streamed("kv") and not rt.streamed("params")
    assert not rt.donate_ok("kv") and rt.donate_ok("params")
    # a RESIDENT host placement is computed on in place: not streamed
    resident = Runtime(ModelSizing(get_config("yi-6b")), "cpu", "kv=host")
    assert resident.streamed("kv") is False and resident.donate_ok("kv")
    host = resident.realize(tree, "kv")
    assert all(t._host_arena is not None for t in tree_leaves(host))
    assert resident.realize(host, "kv") is host


def _windows(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(n, 4, 6, generator=g), "b": torch.randn(n, 3, generator=g)}


@pytest.mark.parametrize("n_windows", [1, 2, 5])
@pytest.mark.parametrize("depth", [2, 3])
def test_host_stream_window_order_and_depth(n_windows, depth):
    tree = _windows(n_windows)
    st = HostStream.stacked(tree, n_windows, "cpu", depth)
    assert st.depth == depth and len(st.buffers()) == depth
    for step in range(2):
        st.begin()
        for i in range(n_windows):
            w = st.window(i)
            assert len(st._held) <= depth
            assert sorted(st._held) == list(range(i, min(i + depth, n_windows)))
            for k in tree:
                assert torch.equal(w[k], tree[k][i])
        st.finish()
    # each step fetches every window once, in order, each ahead of its use
    assert list(st.fetches) == list(range(n_windows)) * 2
    # staging is as large as the largest window, in `depth` slots
    assert st.slot_bytes >= max(st.window_bytes)
    assert st.window_bytes == [4 * (4 * 6 + 3)] * n_windows


def test_host_stream_depth_is_at_least_two_and_writes_back():
    tree = _windows(3)
    st = HostStream.stacked(tree, 3, "cpu", depth=1)
    assert st.depth == 2
    for i in range(3):
        w = st.window(i)
        w["w"].add_(1.0)
        st.write_back(i)
    st.finish()
    assert torch.equal(tree["w"], _windows(3)["w"] + 1.0)
    st.begin()                                    # a new step copies afresh
    assert torch.equal(st.window(0)["w"], tree["w"][0])
    assert list(st.fetches) == [0, 1, 2, 0, 1]
    with pytest.raises(IndexError):
        st.window(3)
    with pytest.raises(ValueError, match="stacked"):
        HostStream.stacked(tree, 4, "cpu")


def test_open_stream_is_rebuilt_by_migrate():
    rt = Runtime(ModelSizing(get_config("yi-6b")), "cpu", "weights_stream")
    host = rt.realize(_windows(4), "params")
    st = rt.open_stream(host, "params", 4)
    assert rt.stream("params") is st and rt.stream("kv") is None
    moved = rt.migrate(host, "params", "kv_host")     # params back to the device
    assert rt.stream("params") is None
    host2 = rt.migrate(moved, "params", "weights_stream")
    assert rt.stream("params") is None                 # closed streams stay closed
    st2 = rt.open_stream(host2, "params", 4)
    rt.migrate(host2, "params", "kv=host:stream,params=host:stream")
    assert rt.stream("params") is not st2
    assert torch.equal(rt.stream("params").window(1)["w"], _windows(4)["w"][1])


def test_calibrate_reprices_and_changes_no_placement(tmp_path):
    bundle = ModelBundle(dataclasses.replace(get_config("yi-6b")))
    rt = Runtime(bundle, "cpu", "kv_host")
    before = rt.decode_step_seconds(8, 2048)
    cal = rt.calibrate(tmp_path / "calibration.json", activate=False,
                       sizes=[1 << 16, 1 << 18], repeats=1)
    assert (tmp_path / "calibration.json").exists()
    assert rt.calibration is cal and rt.policy.name == "kv_host"
    assert rt.system.provenance_of("hbm_bandwidth") == "measured"
    assert rt.decode_step_seconds(8, 2048) != before
    assert len(rt.replay) > 0
