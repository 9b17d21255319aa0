"""The port's fault-injection harness and watchdog, held to the reference.

* the same :class:`FaultPlan` driven through the same site sequence fires
  the same events, raises the same fault types and serializes the same
  schedule and firing record (``to_json``, ``summary``);
* ``checksum_tree`` agrees with the reference's on the same numpy trees
  to 1e-6 relative (the sum order differs) and is exactly stable within
  the port; ``corrupt_tree`` perturbs the element the reference's does;
* the :class:`Watchdog` gives the reference's actions for the same
  observed times, and its config refuses what the reference's refuses;
* the reference lint's ``injected-fault-raise`` rule sees the port's
  raises of injected types only in ``repro_torch/core/faults.py``, each
  under the rule's per-line pragma.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import lint as ref_lint
from repro.core import faults as ref_faults
from repro.core.placement import DonorAxisError as RefDonorAxisError
from repro.runtime.supervisor import Watchdog as RefWatchdog
from repro.runtime.supervisor import WatchdogConfig as RefWatchdogConfig
from repro_torch.core import faults
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import DonorAxisError
from repro_torch.runtime.supervisor import Watchdog, WatchdogConfig

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (site, at, kind, extra) of the schedule both harnesses run
EVENTS = [
    ("decode", 2, "STALL", dict(seconds=0.0, times=2)),
    ("decode", 5, "TIER_LOSS", dict(tier="host")),
    ("migrate", 0, "MIGRATE_FAIL", dict(times=2)),
    ("migrate", 3, "MIGRATE_FAIL", dict(error="donor")),
    ("spill", 1, "SPILL_CORRUPT", {}),
    ("handoff", 0, "TICKET_LOSS", {}),
    ("extract", 1, "TIER_LOSS", dict(tier="peer_hbm")),
    ("realize", 0, "STALL", dict(seconds=0.0)),
]

SITES = (["decode"] * 7 + ["migrate"] * 5 + ["spill"] * 3 + ["handoff"] * 2
         + ["extract"] * 3 + ["realize"] * 2 + ["prefill"])


def _plan(mod, seed=11):
    return mod.FaultPlan([mod.FaultEvent(site, at, mod.FaultKind[kind], **kw)
                          for site, at, kind, kw in EVENTS], seed=seed)


def _drive(plan, order):
    """Each site pass in ``order``: what it returned or raised, by name."""
    out = []
    for i, site in enumerate(order):
        try:
            ev = plan.check(site, rid=i)
            out.append(None if ev is None else ev.kind.value)
        except Exception as e:       # noqa: BLE001 - the type is compared
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("order", ["grouped", "interleaved"])
def test_fault_plan_fires_and_serializes_as_the_reference(order):
    sites = list(SITES)
    if order == "interleaved":
        sites = [s for pair in zip(sites, reversed(sites)) for s in pair]
    ref, port = _plan(ref_faults), _plan(faults)
    assert _drive(port, sites) == _drive(ref, sites)
    assert port.to_json() == ref.to_json()
    assert port.summary() == ref.summary()
    assert repr(port) == repr(ref)
    for site in set(sites) | {"checkpoint"}:
        assert port.site_count(site) == ref.site_count(site)
    assert [e.to_json() for e in port.events] == [e.to_json() for e in ref.events]


def test_fault_types_and_falsy_default():
    assert not faults.NO_FAULTS and faults.NO_FAULTS.check("decode") is None
    assert issubclass(faults.MigrationFault, faults.TransientFault)
    assert issubclass(faults.TransientFault, faults.InjectedFault)
    for name in ("TierLossError", "SpillCorruptionError", "TicketLossError"):
        assert issubclass(getattr(faults, name), faults.InjectedFault)
    plan = faults.FaultPlan([faults.FaultEvent("decode", 0, faults.FaultKind.TIER_LOSS,
                                               tier="host")])
    with pytest.raises(faults.TierLossError) as ei:
        plan.check("decode")
    assert ei.value.tier is MemoryTier.HOST
    ref = ref_faults.TierLossError("host")
    assert str(ei.value) == str(ref)
    donor = faults.FaultPlan([faults.FaultEvent("migrate", 0, faults.FaultKind.MIGRATE_FAIL,
                                                error="donor")])
    with pytest.raises(DonorAxisError):
        donor.check("migrate")
    assert str(faults.SpillCorruptionError(3, 1.5, 2.5)) == str(
        ref_faults.SpillCorruptionError(3, 1.5, 2.5))
    assert str(faults.TicketLossError(4)) == str(ref_faults.TicketLossError(4))
    assert issubclass(RefDonorAxisError, ValueError) and issubclass(DonorAxisError, ValueError)


def _trees(seed):
    """A cache-shaped numpy tree (dict keys out of sorted order, a list,
    mixed dtypes) and its jnp and torch twins."""
    rng = np.random.default_rng(seed)
    tree = {"stages": [{"1M": {"ssm": rng.normal(size=(2, 3, 4, 5)).astype(np.float32),
                               "conv": rng.normal(size=(2, 3, 3, 8)).astype(np.float32)},
                        "0F": {"v": rng.normal(size=(2, 3, 1, 16, 4)).astype(np.float32),
                               "k": rng.normal(size=(2, 3, 1, 16, 4)).astype(np.float32)}}],
            "a": (rng.normal(size=(7,)) * 100).astype(np.float32)}
    j = jax.tree.map(jnp.asarray, tree)
    t = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    return tree, j, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checksum_agrees_with_the_reference_and_is_stable(seed):
    _, j, t = _trees(seed)
    ref = ref_faults.checksum_tree(j)
    got = faults.checksum_tree(t)
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)
    assert faults.checksum_tree(t) == got                      # exactly stable
    bf = jax.tree.map(lambda x: x.to(torch.bfloat16), t)
    assert faults.checksum_tree(bf) == faults.checksum_tree(bf)
    assert faults.checksum_tree(bf) == pytest.approx(ref_faults.checksum_tree(
        jax.tree.map(lambda x: jnp.asarray(x.float().numpy()), bf)), rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_corrupt_tree_perturbs_the_references_element(seed):
    _, j, t = _trees(seed)
    want = jax.tree.map(np.asarray, ref_faults.corrupt_tree(j))
    good = faults.checksum_tree(t)
    got = faults.corrupt_tree(t)
    assert got is t                                      # in place
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), got))):
        np.testing.assert_array_equal(a, b)
    faults.verify_spill(t, None, rid=1)                  # None skips
    with pytest.raises(faults.SpillCorruptionError) as ei:
        faults.verify_spill(t, good, rid=5)
    assert ei.value.rid == 5 and ei.value.expected == good


def test_verify_spill_passes_clean_rows():
    _, _, t = _trees(4)
    faults.verify_spill(t, faults.checksum_tree(t), rid=0)


#: observed step seconds fed to both watchdogs
OBSERVED = [0.05, 1.0, 1.0, 1.0, 1.0, 0.05, 1.0, 0.05, 1.0, 1.0, 1.0, 1.0, 1.0, 0.01]


@pytest.mark.parametrize("kw", [
    {}, dict(budget_factor=10.0, min_deadline_s=0.1),
    dict(stall_after=2, retry_after=2, evacuate_after=4, hang_after=5),
    dict(budget_factor=100.0),
])
def test_watchdog_actions_match_the_reference(kw):
    """Both watchdogs see the same observed times under the same expected
    step time, which moves between observations."""
    t = {"s": 0.0}
    ref = RefWatchdog(lambda: t["s"], RefWatchdogConfig(**kw))
    port = Watchdog(lambda: t["s"], WatchdogConfig(**kw))
    got, want = [], []
    for i, seconds in enumerate(OBSERVED):
        t["s"] = (0.01, 0.02, 0.2, 0.01)[i % 4]
        want.append(ref.observe(seconds))
        got.append(port.observe(seconds))
        assert port.deadline_s() == ref.deadline_s()
    assert got == want
    assert port.actions == ref.actions and port.breaches == ref.breaches
    assert port.last_step_s == ref.last_step_s
    assert Watchdog.ACTIONS == RefWatchdog.ACTIONS


@pytest.mark.parametrize("kw", [
    dict(stall_after=3, retry_after=2), dict(stall_after=0),
    dict(evacuate_after=5, hang_after=4), dict(retry_after=-1),
])
def test_watchdog_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as ref:
        RefWatchdogConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        Watchdog(lambda: 0.01, WatchdogConfig(**kw))
    assert str(got.value) == str(ref.value)


def test_watchdog_defaults_and_deadline_are_the_references():
    assert WatchdogConfig() == WatchdogConfig(8.0, 0.25, 1, 2, 3, 4)
    t = {"s": 1.0}
    wd = Watchdog(lambda: t["s"], WatchdogConfig(budget_factor=2.0))
    assert wd.deadline_s() == pytest.approx(2.0)
    t["s"] = 0.001
    assert wd.deadline_s() == pytest.approx(0.25)       # floored


def test_injected_raises_only_in_the_harness_under_the_pragma():
    """The reference lint's rule, run over the port, finds no violation;
    without its pragmas the port's harness would violate it, and no other
    port file carries the pragma."""
    rules = [ref_lint.get_rule("injected-fault-raise")]
    port = ROOT / "src" / "repro_torch"
    path = port / "core" / "faults.py"
    src = path.read_text()
    rel = str(path.relative_to(ROOT))
    assert [v for v in ref_lint.lint_source(src, rel, rules=rules)
            if v.rule == "injected-fault-raise"] == []
    bare = src.replace("  # repro: lint-disable=injected-fault-raise", "")
    hits = [v for v in ref_lint.lint_source(bare, rel, rules=rules)
            if v.rule == "injected-fault-raise"]
    assert len(hits) == src.count("lint-disable=injected-fault-raise") == 4
    carriers = [p.relative_to(port).as_posix() for p in port.rglob("*.py")
                if "lint-disable=injected-fault-raise" in p.read_text()]
    assert carriers == ["core/faults.py"]
