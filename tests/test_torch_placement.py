"""The port's placement grammar and registry against the JAX reference's.

* every seeded policy's ``to_spec``/``to_json`` and description equal the
  reference's, and the registry holds the same names in the same order;
* ``parse_policy`` gives the same policy for every spelling of the
  grammar (names, compact grammar with every alias, JSON string and dict),
  and the same errors for malformed ones;
* ``Placement.parse``, ``policy`` and ``PolicyBuilder`` agree;
* ``validate_policy_for_mesh``/``donor_allow_flags``/``donor_axes_for``
  agree over axis maps with and without donor axes (the reference reads
  ``mesh.shape``; the port takes the axis map itself).
"""

import itertools
import json

import pytest

from repro.core import placement as rP
from repro.core.hardware import MemoryTier as rTier
from repro_torch.core import placement as pP
from repro_torch.core.hardware import MemoryTier as pTier

GRAMMAR = [
    "hbm_resident",
    "kv_host",
    "kv=host:stream",
    "kv=host:stream,params=peer_hbm",
    " weights = ddr : stream , opt = ddr_p:stream ",
    "kv_cache=hbm_p,master=host_p:stream",
    "act=device,inputs=hbm",
    "grads=remote_hbm,params=hbm_r",
    "opt_state=peer_host:resident,kv=HOST",
    "params=hbm,",
    json.dumps({"name": "custom_one", "description": "d",
                "placements": {"kv_cache": "host:stream"}}),
    json.dumps({"placements": {"params": "peer_hbm:stream", "opt": "host"}}),
]

BAD = [
    "nonsense",
    "kv=tape",
    "kv=host:teleport",
    "ram=host",
    "kv",
    "kv=host,params",
    "[1, 2]",
]

AXES = [None, {}, {"data": 4, "model": 2}, {"donor": 2, "data": 2},
        {"donor": 1, "donor_pod": 1}, {"donor_pod": 2}, {"donor_pod": 2, "donor": 2, "data": 2}]


class _FakeMesh:
    """Duck-typed mesh: the reference's donor checks read ``.shape``."""

    def __init__(self, axes):
        self.shape = dict(axes)


def _mesh(axes):
    return None if axes is None else _FakeMesh(axes)


def _same(r, p):
    assert p.name == r.name
    assert p.description == r.description
    assert p.to_spec() == r.to_spec()
    assert p.to_json() == r.to_json()
    assert p.to_json(indent=2) == r.to_json(indent=2)
    assert sorted(t.value for t in p.tiers()) == sorted(t.value for t in r.tiers())
    assert p.uses_host == r.uses_host


def test_registry_names_and_order_equal():
    assert list(pP.registered_policies()) == list(rP.registered_policies())


@pytest.mark.parametrize("name", list(rP.registered_policies()))
def test_seeded_policy_serializes_as_the_reference(name):
    r, p = rP.get_policy(name), pP.get_policy(name)
    _same(r, p)
    for role in rP.Role:
        rp, pp = r.placement(role), p.placement(pP.Role(role.value))
        assert (pp.tier.value, pp.strategy.value, pp.to_str(), pp.on_host) == (
            rp.tier.value, rp.strategy.value, rp.to_str(), rp.on_host)
    # the JSON round trip is exact on both sides
    assert pP.PlacementPolicy.from_json(p.to_json()) == p
    assert pP.parse_policy(p.to_json()).to_json() == r.to_json()


@pytest.mark.parametrize("text", GRAMMAR)
def test_parse_policy_agrees_and_round_trips(text):
    r, p = rP.parse_policy(text), pP.parse_policy(text)
    _same(r, p)
    again = pP.parse_policy(p.to_json())
    assert again.to_json() == p.to_json()
    if p.to_spec():
        assert pP.parse_policy(p.to_spec()).to_spec() == r.to_spec()
    assert pP.parse_policy(json.loads(p.to_json())).to_json() == r.to_json()


@pytest.mark.parametrize("text", BAD)
def test_bad_spellings_raise_as_the_reference(text):
    with pytest.raises(ValueError) as rerr:
        rP.parse_policy(text)
    with pytest.raises(ValueError) as perr:
        pP.parse_policy(text)
    assert str(perr.value) == str(rerr.value)


def test_pools_directive_is_refused():
    with pytest.raises(ValueError, match="pools="):
        rP.parse_policy("kv=hbm,pools=prefill:1")
    with pytest.raises(ValueError, match="ROADMAP A13"):
        pP.parse_policy("kv=hbm,pools=prefill:1")


@pytest.mark.parametrize(
    "tier,strategy",
    itertools.product(["hbm", "host", "peer_hbm", "peer_host", "remote_hbm",
                       "hbm_p", "host_p", "hbm_r", "device", "ddr", "ddr_p"],
                      ["", ":resident", ":stream"]))
def test_placement_parse_agrees(tier, strategy):
    r, p = rP.Placement.parse(tier + strategy), pP.Placement.parse(tier + strategy)
    assert (p.tier.value, p.strategy.value, p.to_str()) == (
        r.tier.value, r.strategy.value, r.to_str())


def test_policy_constructor_and_builder_agree():
    kw = dict(kv="host:stream", params="peer_hbm", opt="ddr_p:stream")
    _same(rP.policy(**kw), pP.policy(**kw))
    _same(rP.policy("named", "why", kv="host"), pP.policy("named", "why", kv="host"))
    r = (rP.PolicyBuilder("b").place("kv_cache", "host:stream")
         .place(rP.Role.PARAMS, rP.Placement(rTier.PEER_HBM)).describe("x").build())
    p = (pP.PolicyBuilder("b").place("kv_cache", "host:stream")
         .place(pP.Role.PARAMS, pP.Placement(pTier.PEER_HBM)).describe("x").build())
    _same(r, p)
    _same(rP.PolicyBuilder().place("act", "host").build(),
          pP.PolicyBuilder().place("act", "host").build())
    wp = pP.HBM_RESIDENT.with_placement(pP.Role.KV_CACHE, pP.Placement.parse("host"))
    wr = rP.HBM_RESIDENT.with_placement(rP.Role.KV_CACHE, rP.Placement.parse("host"))
    _same(wr, wp)
    _same(rP.KV_HOST.renamed("other"), pP.KV_HOST.renamed("other"))


def test_register_policy_rules_agree():
    for mod in (rP, pP):
        extra = mod.policy("test_extra_policy", kv="host")
        try:
            mod.register_policy(extra)
            assert mod.get_policy("test_extra_policy") is extra
            assert mod.parse_policy("test_extra_policy") is extra
            with pytest.raises(ValueError, match="already registered"):
                mod.register_policy(extra)
            mod.register_policy(extra.renamed("test_extra_policy", "new"),
                                overwrite=True)
            with pytest.raises(ValueError, match="unnamed"):
                mod.register_policy(mod.PlacementPolicy("", {}))
        finally:
            mod._REGISTRY.pop("test_extra_policy", None)
    with pytest.raises(KeyError) as rerr:
        rP.get_policy("absent")
    with pytest.raises(KeyError) as perr:
        pP.get_policy("absent")
    assert str(perr.value) == str(rerr.value)
    assert list(pP.registered_policies()) == list(rP.registered_policies())


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_donor_allow_flags_agree(axes):
    # the reference's host flag is its backend's host_available(); the
    # port realizes no host tier yet, so its flag is False
    got, want = pP.donor_allow_flags(axes), rP.donor_allow_flags(_mesh(axes))
    assert got.pop("allow_host") is False
    assert want.pop("allow_host") is rP.host_available()
    assert got == want


@pytest.mark.parametrize("axes", AXES, ids=str)
@pytest.mark.parametrize("name", list(rP.registered_policies()))
def test_validate_policy_for_mesh_agrees(axes, name):
    def outcome(fn, *args):
        try:
            fn(*args)
            return None
        except ValueError as e:
            assert type(e).__name__ == "DonorAxisError"
            return str(e).split(";")[0]

    r = outcome(rP.validate_policy_for_mesh, rP.get_policy(name), _mesh(axes))
    p = outcome(pP.validate_policy_for_mesh, pP.get_policy(name), axes)
    assert p == r
    for tier in rTier:
        r_axes = outcome(rP.donor_axes_for, _mesh(axes), tier)
        p_axes = outcome(pP.donor_axes_for, axes, pTier(tier.value))
        assert p_axes == r_axes
