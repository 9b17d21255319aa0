"""Faults, recovery, live replans and the watchdog in the port's server.

Each recovery path leaves the greedy tokens of the same port run without
it, and those are the reference ``Server``'s (``mesh=None``,
``hbm_resident``) on the same weights — the reference's host-placed runs
and memory kinds are not taken as ground truth (ROADMAP C2, C3):

* a mid-serve ``replan`` to a forced ``kv_host`` and back (the trees
  really move on one device, where the reference's ``mesh=None`` replan
  returns False);
* a ``host`` tier loss under a forced ``kv_host`` (the cache evacuates to
  the device's memory);
* a corrupted spill (the request replays) and a transient migration
  failure (retried);
* the watchdog's ladder: an injected stall past the deadline is counted,
  a second one rebuilds the steps, a third evacuates the far tier, a
  fourth raises :class:`ServeHangError` (held to the port's run without
  the stalls).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.api import Runtime
from repro_torch.configs import smoke_config
from repro_torch.core.faults import FaultEvent, FaultKind, FaultPlan
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import DonorAxisError, Role, get_policy
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.runtime.supervisor import WatchdogConfig
from repro_torch.serve import Request, ServeConfig, ServeHangError, Server
from repro_torch.serve.engine import Executor

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module", params=["yi-6b", "mamba2-780m"])
def case(request):
    """The port's bundle and weights (carried from the reference's) and the
    reference Server's greedy tokens for :func:`_prompts`."""
    arch = request.param
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jserver = JaxServer(jb, JaxServeConfig(**_cfg()), jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=_new(i))
            for i, p in enumerate(_prompts(jb.cfg.vocab))]
    jserver.add_requests(reqs)
    jserver.run_until_done(2000)
    return tb, tparams, [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def olmo():
    tb = ModelBundle(dataclasses.replace(smoke_config("olmo-1b"), dtype="float32"))
    return tb, tb.init_params(torch.Generator().manual_seed(0))


def _prompts(vocab, n=6):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, 3 + 4 * i).astype(np.int32) for i in range(n)]


def _new(i):
    return 8 + 3 * (i % 3)


def _cfg(**kw):
    return {"batch_slots": 2, "max_len": 48, "prefill_chunk": 4, **kw}


def _run(tb, params, hook=None, setup=None, **kw):
    """Serve :func:`_prompts` on the port; ``setup(server)`` before the
    first tick, ``hook(server, tick)`` after each.  Returns (tokens per
    rid, server)."""
    server = Server(tb, ServeConfig(**_cfg(**kw)), params, device="cpu")
    if setup is not None:
        setup(server)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=_new(i))
            for i, p in enumerate(_prompts(tb.cfg.vocab))]
    server.add_requests(reqs)
    n = 0
    while server.has_work():
        server.step()
        n += 1
        if hook is not None:
            hook(server, n)
        assert n < 2000
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], server


def test_replan_to_kv_host_and_back_mid_serve(case):
    tb, params, want = case
    base, _ = _run(tb, params)
    seen = []

    def replan(server, n):
        if n in (3, 7):
            target = "kv_host" if n == 3 else "hbm_resident"
            assert server.replan(target)
            seen.append((server.policy.name, server.engine.feed is not None,
                         {t.device.type for t in tree_leaves(server.engine.caches)}))
        if n == 5:
            assert not server.replan("kv=host:stream")     # the same placements
            assert server.replan("kv=host:stream", force=True)

    got, server = _run(tb, params, hook=replan)
    assert got == base == want
    st = server.stats()
    assert st["migrations"] == 3 and st["replans"] == 4
    assert seen == [("kv_host", True, {"cpu"}), ("hbm_resident", False, {"cpu"})]
    assert [m[:2] for m in server.engine.migration_log] == [
        ("replan", "kv_host"), ("replan", "custom(kv_cache=host:stream)"),
        ("replan", "hbm_resident")]


def test_host_tier_loss_under_kv_host_evacuates(case):
    tb, params, want = case
    base, _ = _run(tb, params, policy="kv_host")
    plan = FaultPlan([FaultEvent("decode", at=5, kind=FaultKind.TIER_LOSS, tier="host")])
    got, server = _run(tb, params, policy="kv_host", faults=plan)
    st = server.stats()
    assert got == base == want
    assert st["tier_losses"] == 1 and st["evacuations"] == 1 and st["migrations"] == 1
    assert MemoryTier.HOST in server.runtime.lost_tiers
    assert server.policy.placement(Role.KV_CACHE).tier is MemoryTier.HBM
    assert server.engine.feed is None
    assert server.runtime.spill_placement().tier is MemoryTier.HBM
    assert len(plan.fired) == 1


def test_spill_corruption_and_transient_migration_failure(case):
    """A corrupted spill replays its request; a tier loss's evacuation
    survives one transient migration failure; tokens unchanged."""
    tb, params, want = case
    plan = FaultPlan([
        FaultEvent("spill", at=0, kind=FaultKind.SPILL_CORRUPT),
        FaultEvent("decode", at=9, kind=FaultKind.TIER_LOSS, tier="host"),
        FaultEvent("migrate", at=0, kind=FaultKind.MIGRATE_FAIL),
    ])
    got, server = _run(tb, params, policy="kv_host", preempt=True, preempt_wait=2,
                       faults=plan)
    st = server.stats()
    assert got == want
    assert st["spill_corruptions"] == 1 and st["requeued_fresh"] >= 1
    assert st["migration_retries"] == 1 and st["evacuations"] == 1
    assert st["preemptions"] >= 2
    assert server.engine._spill_pool == []      # no spill lands on host again
    assert [f[2].kind for f in plan.fired][:1] == [FaultKind.SPILL_CORRUPT]
    assert {f[2].kind for f in plan.fired} == {FaultKind.SPILL_CORRUPT,
                                               FaultKind.TIER_LOSS,
                                               FaultKind.MIGRATE_FAIL}


def test_replan_while_a_sequence_is_parked(case):
    """Replans hbm_resident -> kv_host -> hbm_resident while preempted rows
    are parked: each promotion verifies the parked rows against their
    park-time checksum, none is taken for corrupt, and the tokens are the
    reference's."""
    tb, params, want = case
    moves = []

    def replan(server, n):
        if server._spilled and len(moves) < 2 and (not moves or n > moves[-1] + 1):
            assert server.replan("kv_host" if not moves else "hbm_resident")
            moves.append(n)

    got, server = _run(tb, params, hook=replan, preempt=True, preempt_wait=2,
                       verify_spills=True)
    st = server.stats()
    assert got == want
    assert len(moves) == 2 and st["migrations"] == 2
    assert st["spill_corruptions"] == 0 and st["requeued_fresh"] == 0
    assert st["preemptions"] >= 2 and st["promotions"] == st["preemptions"]


def test_failed_replan_adopts_nothing(case):
    """A permanent (donor-axis) failure at the first migration leaves the
    policy object, the steps and the tokens as they were."""
    tb, params, want = case
    plan = FaultPlan([FaultEvent("migrate", at=0, kind=FaultKind.MIGRATE_FAIL,
                                 error="donor")])

    def replan(server, n):
        if n == 2:
            old, feed = server.policy, server.engine.feed
            with pytest.raises(DonorAxisError):
                server.replan("kv_host")
            assert server.policy is old and server.engine.feed is feed
            assert server.stats()["migrations"] == 0

    got, _ = _run(tb, params, hook=replan, faults=plan)
    assert got == want


#: the watchdog tests' deadline: the floor, far above a smoke step even on
#: a loaded host (the step price is pinned low), and the stall past it
WATCHDOG = WatchdogConfig(min_deadline_s=0.8)
STALL_S = 1.2


def _pinned_price(server):
    server.watchdog.expected_s = lambda: 0.01


def test_watchdog_ladder_stall_retry_evacuate(olmo):
    """Consecutive decode stalls past the deadline under kv_host: counted,
    then the steps rebuilt, then the host tier abandoned.  The first step
    after a rebuild pays set-up and is not observed (the step EWMA's
    rule), so five stalled passes make three observed breaches."""
    tb, params = olmo
    base, _ = _run(tb, params, policy="kv_host")
    plan = FaultPlan([FaultEvent("decode", at=4, kind=FaultKind.STALL, seconds=STALL_S,
                                 times=5)])
    got, server = _run(tb, params, setup=_pinned_price, policy="kv_host", faults=plan,
                       watchdog=WATCHDOG)
    st = server.stats()
    assert got == base
    assert (st["watchdog_stalls"], st["watchdog_retries"], st["watchdog_evacuations"]) \
        == (1, 1, 1)
    assert server.watchdog.actions["hang"] == 0
    assert server.policy.placement(Role.KV_CACHE).tier is MemoryTier.HBM
    assert MemoryTier.HOST in server.runtime.lost_tiers


def test_watchdog_hangs_with_diagnostics(olmo):
    """Under hbm_resident there is no far tier to abandon: the evacuate
    rung counts as a stall and the fourth observed breach raises."""
    tb, params = olmo
    plan = FaultPlan([FaultEvent("decode", at=4, kind=FaultKind.STALL, seconds=STALL_S,
                                 times=5)])
    with pytest.raises(ServeHangError) as ei:
        _run(tb, params, setup=_pinned_price, faults=plan, watchdog=WATCHDOG)
    err = ei.value
    assert "watchdog: 4 consecutive steps" in str(err)
    snapshot = dict(err.stats)
    assert snapshot["watchdog_stalls"] == 2 and snapshot["watchdog_retries"] == 1
    assert err.live_rids


def test_watchdog_off_and_default(olmo):
    tb, params = olmo
    assert Server(tb, ServeConfig(**_cfg(watchdog=None)), params,
                  device="cpu").watchdog is None
    server = Server(tb, ServeConfig(**_cfg()), params, device="cpu")
    assert server.watchdog.cfg == WatchdogConfig()
    assert server.watchdog.deadline_s() == max(
        0.25, 8.0 * server.runtime.decode_step_seconds(2, 48))


def test_auto_replan_follows_occupancy_bands(olmo):
    """Planner-owned policy: a replan per band crossing, no migration
    (the CPU planner keeps hbm_resident); a forced policy never replans."""
    tb, params = olmo
    base, _ = _run(tb, params)
    got, server = _run(tb, params, auto_replan=True, replan_bands=4)
    assert got == base
    assert server.stats()["replans"] >= 2 and server.stats()["migrations"] == 0
    _, forced = _run(tb, params, auto_replan=True, policy="hbm_resident")
    assert forced.stats()["replans"] == 0


def test_runtime_evacuate_moves_roles_off_a_lost_tier():
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    cache = tb.init_cache(2, 16, device="cpu")
    for t in tree_leaves(cache):
        t.copy_(torch.randn(t.shape))
    rt = Runtime(tb, "cpu", "kv_host")
    host = rt.realize(cache, Role.KV_CACHE)
    trees = {Role.KV_CACHE: host, Role.PARAMS: params}
    policy, moved = rt.evacuate("host", trees)
    assert moved == [Role.KV_CACHE] and policy is rt.policy
    assert policy.name == "kv_host-evac-host"
    assert policy.placement(Role.KV_CACHE).tier is MemoryTier.HBM
    assert trees[Role.PARAMS] is params
    for a, b in zip(tree_leaves(cache), tree_leaves(trees[Role.KV_CACHE])):
        assert torch.equal(a, b) and getattr(b, "_host_arena", None) is None
    # nothing left on the lost tier: nothing moves, the planner is not asked
    assert rt.evacuate("host", trees, phase="serve") == (policy, [])
    # with the planner's re-pick
    rt2 = Runtime(tb, "cpu", "kv_host")
    trees = {Role.KV_CACHE: rt2.realize(cache, Role.KV_CACHE), Role.PARAMS: params}
    policy, moved = rt2.evacuate("host", trees, phase="serve", batch_slots=2, max_len=16)
    assert moved == [Role.KV_CACHE] and policy == get_policy("hbm_resident")


def test_fault_sites_on_realize_and_extract(olmo):
    """The runtime's ``realize`` and the executor's ``extract`` consult the
    plan: a tier loss at the first realize fails the server's
    construction; a transient failure at an extract fails that spill."""
    tb, params = olmo
    from repro_torch.core.faults import MigrationFault, TierLossError

    plan = FaultPlan([FaultEvent("realize", at=0, kind=FaultKind.TIER_LOSS, tier="host")])
    with pytest.raises(TierLossError):
        Server(tb, ServeConfig(**_cfg(faults=plan)), params, device="cpu")
    plan = FaultPlan([FaultEvent("extract", at=0, kind=FaultKind.MIGRATE_FAIL)])
    server = Server(tb, ServeConfig(**_cfg(faults=plan)), params, device="cpu")
    assert server.runtime.faults is plan and plan.site_count("realize") == 2
    server.submit(np.arange(1, 6), max_new_tokens=4)
    server.step()
    with pytest.raises(MigrationFault):
        server.engine.extract_slot(0, server.runtime.spill_placement())


def test_cache_without_the_batch_on_axis_1_is_refused(olmo):
    tb, params = olmo

    class Transposed(ModelBundle):
        def init_cache(self, batch, max_len, dtype=None, device=None):
            cache = super().init_cache(batch, max_len, dtype, device)
            return {"stages": [{k: {n: t.transpose(0, 1) for n, t in v.items()}
                                for k, v in stage.items()} for stage in cache["stages"]]}

    bad = Transposed(tb.cfg)
    with pytest.raises(ValueError, match="batch on axis 1"):
        Executor(bad, ServeConfig(**_cfg(batch_slots=3)), params, "cpu")
