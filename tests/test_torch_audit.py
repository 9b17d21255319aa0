"""The port's data-movement audit (``repro_torch.analysis.transfer_audit``
and ``Runtime.audit``), mirroring ``tests/test_analysis_audit.py``.

The reference audits compiled HLO text; the port runs the step and reads
what it did.  Each of the reference's fixtures (a clean in-place module, a
missed donation, a forbidden one, a stray host transfer) goes through the
reference's ``audit_hlo_text`` and, as the same case in the port's terms
(a step and, for transfers, injected copy records), through the port's
``audit_step``: the two reports agree in kinds, bytes, in-place counts
and verdict.  Then every CPU ``Executor`` build is audited: smoke models
under the in-memory and the streamed placements, a bundle that copies its
cache instead of writing it in place, and the planner's byte plan.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo_audit import ExpectedMovement as JExpected
from repro.analysis.hlo_audit import RoleExpectation as JRole
from repro.analysis.hlo_audit import audit_hlo_text
from repro.configs import ShapeSpec as JShape
from repro.configs import smoke_config as jax_smoke_config
from repro.core.placement import Role as JaxRole
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.analysis.transfer_audit import (
    ERROR_KINDS,
    AuditViolation,
    DonationAliasError,
    ExpectedMovement,
    RoleExpectation,
    StepTarget,
    audit_step,
)
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.core.op_analysis import TransferStat, transfers_from_trace
from repro_torch.core.placement import Role
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, Server

# -- the reference's synthetic modules (tests/test_analysis_audit.py) --------

CLEAN_DONATED = """\
HloModule clean, input_output_alias={ {0}: (1, {}, may-alias) }

ENTRY %main (p0: f32[16], p1: f32[64]) -> (f32[64]) {
  %p0 = f32[16]{0} parameter(0), metadata={op_name="p[\\'w\\']"}
  %p1 = f32[64]{0} parameter(1), metadata={op_name="caches[0]"}
  ROOT %t = (f32[64]{0}) tuple(%p1)
}
"""

NO_ALIAS = """\
HloModule no_alias

ENTRY %main (p0: f32[16], p1: f32[64]) -> (f32[64]) {
  %p0 = f32[16]{0} parameter(0), metadata={op_name="p[\\'w\\']"}
  %p1 = f32[64]{0} parameter(1), metadata={op_name="caches[0]"}
  ROOT %t = (f32[64]{0}) tuple(%p1)
}
"""

HOST_TRAFFIC = """\
HloModule host_traffic

ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0), metadata={op_name="caches[0]"}
  %cs = (f32[1024]{0:S(5)}, f32[1024]{0}, u32[]) copy-start(%p0)
  ROOT %cd = f32[1024]{0:S(5)} copy-done(%cs)
}
"""


def _cases():
    """(name, reference HLO, the same case in the port's terms:
    step(cache) -> handed-back trees, the cache's size, copy records)."""
    d2h = [TransferStat("Memcpy DtoH (Device -> Pinned)", "DtoH", 1024 * 4.0,
                        "device", "host")]
    return {
        # the module aliases the cache: the step writes it in place
        "in-place": (CLEAN_DONATED, lambda c: {"caches": [c.add_(1)]}, 64, None),
        # no alias: the step hands back a copy
        "copied": (NO_ALIAS, lambda c: {"caches": [c + 1]}, 64, None),
        # a host copy of the cache
        "host-copy": (HOST_TRAFFIC, lambda c: None, 1024, d2h),
    }


def _kv(donate, **kw):
    return (JExpected(roles=(JRole("kv_cache", "caches", donate=donate),), label="t", **kw),
            ExpectedMovement(roles=(RoleExpectation("kv_cache", "caches", donate=donate),),
                             label="t", **kw))


def _port(case, expected):
    _, step, n, records = _cases()[case]
    cache = torch.zeros(n)
    return audit_step(StepTarget(lambda: step(cache), {"caches": [cache]},
                                 records=records), expected)


def _same(ref, port):
    assert [(v.kind, v.severity, v.nbytes, v.tier_edge, v.planner_term)
            for v in ref.violations] == [
        (v.kind, v.severity, v.nbytes, v.tier_edge, v.planner_term) for v in port.violations]
    assert (ref.ok, ref.donation_expected, ref.donation_materialized,
            ref.host_transfer_bytes, ref.role_bytes) == (
        port.ok, port.donation_expected, port.donation_materialized,
        port.host_transfer_bytes, port.role_bytes)
    assert ref.donation_coverage == port.donation_coverage


@pytest.mark.parametrize("case,donate,kw,kinds", [
    ("in-place", True, {}, []),                                     # clean
    ("copied", True, {}, ["missed-donation"]),
    ("in-place", False, {}, ["forbidden-donation"]),
    ("copied", False, {}, []),                                      # clean
    ("host-copy", False, {}, ["stray-host-transfer"]),
    ("host-copy", False, {"host_bytes_allowed": 1024 * 4}, []),     # within allowance
])
def test_fixture_agrees_with_the_reference(case, donate, kw, kinds):
    jexp, texp = _kv(donate, **kw)
    ref = audit_hlo_text(_cases()[case][0], jexp)
    port = _port(case, texp)
    assert [v.kind for v in port.violations] == kinds
    _same(ref, port)


def test_donation_errors_raise_and_transfers_do_not():
    _, texp = _kv(True)
    rep = _port("copied", texp)
    with pytest.raises(DonationAliasError, match="missed-donation"):
        rep.raise_on_donation_errors()
    _, texp = _kv(False)
    with pytest.raises(DonationAliasError, match="forbidden-donation"):
        _port("in-place", texp).raise_on_donation_errors()
    _port("host-copy", texp).raise_on_donation_errors()      # not a donation matter


@pytest.mark.parametrize("plan,warn", [(64 * 4 * 10, True), (64 * 4 * 1.2, False)])
def test_byte_plan_fixture_agrees(plan, warn):
    jexp = JExpected(roles=(JRole("kv_cache", "caches", donate=True, plan_bytes=plan),),
                     label="t")
    texp = ExpectedMovement(roles=(RoleExpectation("kv_cache", "caches", donate=True,
                                                   plan_bytes=plan),), label="t")
    ref, port = audit_hlo_text(CLEAN_DONATED, jexp), _port("in-place", texp)
    _same(ref, port)
    assert [v.kind for v in port.violations] == (["byte-plan-mismatch"] if warn else [])
    assert port.ok


def test_to_json_round_trips_with_the_reference_keys():
    jexp, texp = _kv(True)
    ref, port = audit_hlo_text(NO_ALIAS, jexp), _port("copied", texp)
    blob = json.loads(json.dumps(port.to_json()))
    assert set(ref.to_json()) <= set(blob)
    assert blob["ok"] is False and blob["donation_coverage"] == 0.0
    assert isinstance(AuditViolation(**blob["violations"][0]).to_json(), dict)
    assert set(ERROR_KINDS) == {"missed-donation", "forbidden-donation",
                                "stray-host-transfer"}


def test_streamed_cache_write_back_is_the_placements_own_write():
    cache, params = torch.zeros(8), torch.ones(4)
    exp = ExpectedMovement(roles=(
        RoleExpectation("kv_cache", "caches", donate=False, placement_writes=True),
        RoleExpectation("params", "p", donate=False)))
    rep = audit_step(StepTarget(lambda: {"caches": cache.add_(1)},
                                {"caches": cache, "p": params}), exp)
    assert rep.ok and rep.donation_expected == 0

    def replaces():
        cache.set_(torch.zeros(8))

    rep = audit_step(StepTarget(replaces, {"caches": cache, "p": params}), exp)
    assert [v.kind for v in rep.violations] == ["forbidden-donation"]
    assert "replaced" in rep.violations[0].detail


def test_inference_tensors_are_checked_by_checksum():
    with torch.inference_mode():
        params = torch.ones(4)
    exp = ExpectedMovement(roles=(RoleExpectation("params", "p", donate=False),))
    assert audit_step(StepTarget(lambda: None, {"p": params}), exp).ok

    def writes():
        with torch.inference_mode():
            params.mul_(2.0)

    rep = audit_step(StepTarget(writes, {"p": params}), exp)
    assert [v.kind for v in rep.violations] == ["forbidden-donation"]


def test_copy_records_of_a_trace():
    events = [
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "args": {"bytes": 96}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "args": {"bytes": 64}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "args": {"bytes": 8}},
        {"cat": "kernel", "name": "decode_kernel", "args": {}},
    ]
    recs = transfers_from_trace(events)
    assert [(t.name, t.nbytes, t.crosses_host) for t in recs] == [
        ("HtoD", 96.0, True), ("DtoH", 64.0, True), ("DtoD", 8.0, False)]
    exp = ExpectedMovement(roles=(), host_bytes_allowed=96 + 64)
    assert audit_step(StepTarget(lambda: None, {}, records=recs), exp).ok
    rep = audit_step(StepTarget(lambda: None, {}, records=recs),
                     dataclasses.replace(exp, host_bytes_allowed=100))
    assert [v.kind for v in rep.violations] == ["stray-host-transfer"] * 2
    assert rep.host_transfer_bytes == 160 and rep.bytes_by_direction()["HtoD"] == 96


# -- every CPU Executor build --------------------------------------------------

def _pair(arch):
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    tree = jax.tree.map(np.asarray, jb.init_params(jax.random.PRNGKey(0), "float32"))
    return jb, jax.tree.map(jnp.asarray, tree), tb, convert.params_from_jax(tree, "cpu")


@pytest.fixture(scope="module", params=["olmo-1b", "yi-6b"])
def pair(request):
    return (request.param, *_pair(request.param))


CFG = dict(batch_slots=2, max_len=48, prefill_chunk=4)


def _run_each_step(server, rid=0):
    """Serve one request (its prefill dispatch and decode steps), then
    spill and restore its slot: eagerly, each step's first run after a
    build is the build's audit of it."""
    server.add_requests([Request(rid=rid, prompt=np.arange(1, 8), max_new_tokens=2)])
    server.run_until_done()
    eng = server.engine
    eng.insert_slot(0, eng.extract_slot(0, server.runtime.spill_placement()))


@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "weights_stream"])
def test_every_build_audits_its_steps(pair, policy):
    _, _, _, tb, tparams = pair
    server = Server(tb, ServeConfig(**CFG, policy=policy), tparams, device="cpu")
    eng = server.engine
    assert eng.audit_reports == {}              # no step ran for the audit alone
    _run_each_step(server)
    reps = eng.audit_reports
    assert set(reps) == {"decode", "prefill", "insert"}
    n_cache = len(tree_leaves(eng.caches))
    cache_bytes = float(sum(t.numel() * t.element_size() for t in tree_leaves(eng.caches)))
    in_place = not eng.runtime.streamed(Role.KV_CACHE)
    for name, rep in reps.items():
        assert rep.ok, (name, [str(v) for v in rep.violations])
        assert rep.transfers == [] and not rep.profiled        # the CPU records none
        assert rep.donation_expected == rep.donation_materialized == (
            n_cache if in_place else 0)
        assert rep.role_bytes["kv_cache"] == cache_bytes
        assert policy in rep.label and name in rep.label
    # a rebuild audits again
    eng.replan("hbm_resident", force=True)
    assert eng.audit_reports == {}
    _run_each_step(server, rid=1)
    assert set(eng.audit_reports) == {"decode", "prefill", "insert"}
    assert all(r.ok for r in eng.audit_reports.values())


def test_the_build_audit_changes_no_state():
    _, _, tb, tparams = _pair("yi-6b")
    a = Server(tb, ServeConfig(**CFG), tparams, device="cpu").engine
    fresh = tb.init_cache(CFG["batch_slots"], CFG["max_len"], device="cpu")
    for got, want in zip(tree_leaves(a.caches), tree_leaves(fresh)):
        assert torch.equal(got, want)
    assert not a.out.any()


class _CopyingBundle:
    """A bundle whose decode step hands back a copy of the cache instead of
    writing it in place (``how="copy"``), or writes the params it may only
    read (``how="params"``)."""

    def __init__(self, inner, how):
        self._inner, self._how = inner, how

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def decode_step(self, params, batch, caches, **kw):
        logits, caches = self._inner.decode_step(params, batch, caches, **kw)
        if self._how == "params":
            tree_leaves(params)[0].mul_(1.0)
            return logits, caches
        return logits, tree_map(lambda t: t.clone(), caches)


def test_a_copied_cache_raises_at_its_first_step_under_verify_donation(pair):
    _, _, _, tb, tparams = pair
    server = Server(_CopyingBundle(tb, "copy"), ServeConfig(**CFG), tparams, device="cpu")
    with pytest.raises(DonationAliasError, match="missed-donation"):
        _run_each_step(server)
    server = Server(_CopyingBundle(tb, "copy"), ServeConfig(**CFG, verify_donation=False),
                    tparams, device="cpu")
    _run_each_step(server)
    reps = server.engine.audit_reports
    n_cache = len(tree_leaves(server.engine.caches))
    assert [v.kind for v in reps["decode"].violations] == ["missed-donation"] * n_cache
    assert reps["decode"].donation_coverage == 0.0
    assert reps["prefill"].ok and reps["insert"].ok


def test_written_params_raise_at_their_first_step():
    _, _, tb, tparams = _pair("olmo-1b")
    tparams = tree_map(lambda t: t.clone(), tparams)
    server = Server(_CopyingBundle(tb, "params"), ServeConfig(**CFG), tparams, device="cpu")
    with pytest.raises(DonationAliasError, match="forbidden-donation"):
        _run_each_step(server)


def test_byte_plan_mismatch_matches_the_reference():
    """The same planner workload against the reference's compiled decode
    step and the port's decode step: the same roles flagged, with the same
    observed bytes (float32 smoke weights and cache against a bf16 plan)."""
    jb, jparams, tb, tparams = _pair("olmo-1b")
    shape = dict(seq_len=CFG["max_len"], global_batch=CFG["batch_slots"], mode="decode")
    jserver = JaxServer(jb, JaxServeConfig(**CFG), jparams)
    jeng = jserver.engine
    jrep = jeng.rt.audit(jeng._decode, {"p": JaxRole.PARAMS, "caches": JaxRole.KV_CACHE},
                         donated={"caches"},
                         workload=jb.decode_workload(JShape("serve", **shape)))
    eng = Server(tb, ServeConfig(**CFG), tparams, device="cpu").engine

    def run():
        out = {}
        eng._decode_step(out)
        return out

    trep = eng.runtime.audit(
        StepTarget(run, {"p": eng.params, "caches": eng.caches}),
        {"p": Role.PARAMS, "caches": Role.KV_CACHE}, donated={"caches"},
        workload=tb.decode_workload(ShapeSpec("serve", **shape)))

    def plan(rep):
        return sorted((v.kind, v.severity, v.op, v.nbytes, v.planner_term)
                      for v in rep.violations if v.kind == "byte-plan-mismatch")

    assert plan(trep) and plan(trep) == plan(jrep)
    assert trep.role_bytes == jrep.role_bytes
    assert trep.ok and jrep.ok
