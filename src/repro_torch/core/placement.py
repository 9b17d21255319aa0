"""Placement policies: where every tensor role physically lives (analysis half).

Counterpart of ``repro/core/placement.py``: the tensor roles, the policy
grammar (``role=tier[:strategy],...``), the :class:`PlacementPolicy` value
with its JSON round trip, the registry and the seeded policies, and the
donor-axis checks — pure Python, over the port's
:class:`~repro_torch.core.hardware.MemoryTier`.  The planner
(:mod:`repro_torch.core.planner`) prices every registered policy from the
datapath bounds and picks the fastest one that fits every memory pool.

The paper's application studies (§IV) show that the *physical placement*
of each buffer decides performance, per role: GEMM sources care (reads
dominate), the destination does not; read-mostly buffers like the KV cache
gain from the big slow pool only when the fast pool is full.

What is left out, and why:

* the realization (``sharding``, the placing helpers, ``to_device``/
  ``to_host``, ``DonorStream``, the memory-kind queries and
  ``host_available``): placing a tensor in pinned host memory or on a
  donor card is A9's second half (ROADMAP);
* ``PoolSplit``/``extract_pool_split``, the disaggregated-serve grammar
  (ROADMAP A13);
* the deprecated read-only view of the registry.

The reference's donor checks read ``mesh.shape``; the port has no device
mesh, so :func:`donor_axes_for`, :func:`donor_allow_flags` and
:func:`validate_policy_for_mesh` take a mapping of mesh axis names to sizes
(``None`` for no mesh).  On one card there is no donor axis, so a peer or
remote placement is refused exactly as on a reference mesh without one.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Mapping

from repro_torch.core.hardware import MemoryTier


class Role(str, enum.Enum):
    PARAMS = "params"            # model weights (read every step)
    MASTER = "master"            # f32 master copy of params (optimizer)
    OPT_STATE = "opt_state"      # Adam moments
    GRADS = "grads"              # gradient buffers
    ACTIVATIONS = "activations"  # step-local
    KV_CACHE = "kv_cache"        # decode-state, read-mostly, grows with seq
    INPUTS = "inputs"            # token batches


class Strategy(str, enum.Enum):
    RESIDENT = "resident"   # lives in its tier; computed on in place
    STREAM = "stream"       # lives in a far tier; bulk-moved each use
                            # (paper: "managed"-like — pay the migration,
                            #  then access at HBM speed)


#: canonical tier spellings for the placement string grammar, plus the
#: aliases accepted on input (the MemoryTier enum values and a few
#: paper-flavored spellings).
TIER_NAMES: dict[MemoryTier, str] = {
    MemoryTier.HBM: "hbm",
    MemoryTier.HOST: "host",
    MemoryTier.PEER_HBM: "peer_hbm",
    MemoryTier.PEER_HOST: "peer_host",
    MemoryTier.REMOTE_HBM: "remote_hbm",
}
_TIER_ALIASES: dict[str, MemoryTier] = {
    **{v: k for k, v in TIER_NAMES.items()},
    **{t.value: t for t in TIER_NAMES},   # enum values: hbm_p, host_p, ...
    "device": MemoryTier.HBM,
    "ddr": MemoryTier.HOST,
    "ddr_p": MemoryTier.PEER_HOST,
}

#: role spellings for the grammar: enum values plus short aliases.
_ROLE_ALIASES: dict[str, Role] = {
    **{r.value: r for r in Role},
    "kv": Role.KV_CACHE,
    "weights": Role.PARAMS,
    "opt": Role.OPT_STATE,
    "act": Role.ACTIVATIONS,
}


def parse_role(name: str | Role) -> Role:
    """Role from a grammar spelling (``kv``/``kv_cache``/``params``/...)."""
    if isinstance(name, Role):
        return name
    try:
        return _ROLE_ALIASES[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown tensor role {name!r}; one of "
            f"{sorted(_ROLE_ALIASES)}"
        ) from None


def parse_tier(name: str | MemoryTier) -> MemoryTier:
    """MemoryTier from a grammar spelling (``hbm``/``peer_hbm``/...)."""
    if isinstance(name, MemoryTier):
        return name
    try:
        return _TIER_ALIASES[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown memory tier {name!r}; one of "
            f"{sorted(set(_TIER_ALIASES))}"
        ) from None


#: tiers whose bytes live in a host DRAM pool (vs an HBM pool).
HOST_TIERS = frozenset({MemoryTier.HOST, MemoryTier.PEER_HOST})

#: donor mesh-axis convention: an axis with this name groups the local
#: slice with the memory-donor slices; peer/remote-tier tensors are
#: sharded across it.
DONOR_AXIS = "donor"
REMOTE_DONOR_AXIS = "donor_pod"

#: which donor axis realizes each far tier (NVLink donors vs InfiniBand).
TIER_DONOR_AXIS: dict[MemoryTier, str] = {
    MemoryTier.PEER_HBM: DONOR_AXIS,
    MemoryTier.PEER_HOST: DONOR_AXIS,
    MemoryTier.REMOTE_HBM: REMOTE_DONOR_AXIS,
}


class DonorAxisError(ValueError):
    """A placement needs a donor mesh axis the active mesh does not have."""


def _axes(mesh_axes: Mapping[str, int] | None) -> dict[str, int]:
    return dict(mesh_axes) if mesh_axes is not None else {}


def donor_axes_for(mesh_axes: Mapping[str, int] | None,
                   tier: MemoryTier) -> tuple[str, ...]:
    """Mesh axes that realize ``tier``'s donor placement (empty for local
    tiers).  Raises :class:`DonorAxisError` when ``tier`` needs a donor
    axis and ``mesh_axes`` has none of size >= 2."""
    axis = TIER_DONOR_AXIS.get(tier)
    if axis is None:
        return ()
    if _axes(mesh_axes).get(axis, 1) < 2:
        raise DonorAxisError(
            f"tier {tier} needs a {axis!r} mesh axis of size >= 2 to be "
            f"realized; mesh axes are {_axes(mesh_axes) or None}"
        )
    return (axis,)


def donor_allow_flags(mesh_axes: Mapping[str, int] | None) -> dict[str, bool]:
    """``allow_*`` kwargs for :func:`repro_torch.core.planner.plan`: peer
    tiers need a :data:`DONOR_AXIS`, remote tiers a
    :data:`REMOTE_DONOR_AXIS`.  Host tiers need a realization the port
    does not have yet (A9's second half), so ``allow_host`` is False, as
    the reference's ``host_available()`` gives on a backend with no
    distinct host memory."""
    axes = _axes(mesh_axes)
    return {
        "allow_host": False,
        "allow_peer": axes.get(DONOR_AXIS, 1) > 1,
        "allow_remote": axes.get(REMOTE_DONOR_AXIS, 1) > 1,
    }


def validate_policy_for_mesh(policy: "PlacementPolicy",
                             mesh_axes: Mapping[str, int] | None) -> None:
    """Raise :class:`DonorAxisError` if ``policy`` places any role in a
    peer/remote tier the mesh cannot realize, so a donor placement never
    silently lands in local memory."""
    for role, pl in policy.placements.items():
        try:
            donor_axes_for(mesh_axes, pl.tier)
        except DonorAxisError as e:
            raise DonorAxisError(
                f"policy {policy.name!r} places {role.value} in {pl.tier}: {e}"
            ) from None


@dataclasses.dataclass(frozen=True)
class Placement:
    tier: MemoryTier = MemoryTier.HBM
    strategy: Strategy = Strategy.RESIDENT

    @property
    def on_host(self) -> bool:
        return self.tier in HOST_TIERS

    def to_str(self) -> str:
        """Grammar form: ``tier[:strategy]`` (``:resident`` is implied)."""
        tier = TIER_NAMES[self.tier]
        if self.strategy is Strategy.RESIDENT:
            return tier
        return f"{tier}:{self.strategy.value}"

    @classmethod
    def parse(cls, text: "str | Placement") -> "Placement":
        """Placement from ``tier[:strategy]`` (``host:stream``, ``peer_hbm``)."""
        if isinstance(text, Placement):
            return text
        tier_s, _, strat_s = text.partition(":")
        tier = parse_tier(tier_s)
        if not strat_s:
            return cls(tier, Strategy.RESIDENT)
        try:
            strategy = Strategy(strat_s.strip().lower())
        except ValueError:
            raise ValueError(
                f"unknown placement strategy {strat_s!r} in {text!r}; one "
                f"of {[s.value for s in Strategy]}"
            ) from None
        return cls(tier, strategy)


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Named per-role placement map (the paper's 'allocation policy')."""

    name: str
    placements: Mapping[Role, Placement]
    description: str = ""

    def placement(self, role: Role) -> Placement:
        return self.placements.get(role, Placement())

    def tiers(self) -> frozenset[MemoryTier]:
        """Every tier this policy places at least one role in."""
        return frozenset(
            {MemoryTier.HBM} | {p.tier for p in self.placements.values()}
        )

    @property
    def uses_host(self) -> bool:
        return any(p.on_host for p in self.placements.values())

    def with_placement(self, role: Role, placement: Placement) -> "PlacementPolicy":
        p = dict(self.placements)
        p[role] = placement
        return PlacementPolicy(self.name, p, self.description)

    def renamed(self, name: str, description: str | None = None) -> "PlacementPolicy":
        return PlacementPolicy(
            name, dict(self.placements),
            self.description if description is None else description,
        )

    # -- serialization ----------------------------------------------------
    def to_spec(self) -> str:
        """Compact grammar form: ``role=tier[:strategy],...`` (sorted,
        ``hbm``-resident roles omitted — they are the default)."""
        return ",".join(
            f"{role.value}={pl.to_str()}"
            for role, pl in sorted(
                self.placements.items(), key=lambda kv: kv[0].value
            )
            if pl != Placement()
        )

    def to_json(self, *, indent: int | None = None) -> str:
        """JSON form; :meth:`from_json` round-trips it exactly."""
        return json.dumps(
            {
                "name": self.name,
                "description": self.description,
                "placements": {
                    role.value: pl.to_str()
                    for role, pl in sorted(
                        self.placements.items(), key=lambda kv: kv[0].value
                    )
                },
            },
            indent=indent,
        )

    @classmethod
    def from_json(cls, data: "str | Mapping") -> "PlacementPolicy":
        """Inverse of :meth:`to_json`; also accepts the already-parsed
        dict form (configs embed it without re-stringifying)."""
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        if not isinstance(data, Mapping):
            raise ValueError(
                f"policy JSON must decode to an object, got {type(data)}"
            )
        placements = {
            parse_role(role): Placement.parse(pl)
            for role, pl in dict(data.get("placements", {})).items()
        }
        name = data.get("name") or _spec_name(placements)
        return cls(name, placements, data.get("description", ""))


def _spec_name(placements: Mapping[Role, Placement]) -> str:
    """Canonical derived name for an anonymous policy (stable across
    round-trips: sorted compact-grammar body)."""
    body = ",".join(
        f"{role.value}={pl.to_str()}"
        for role, pl in sorted(placements.items(), key=lambda kv: kv[0].value)
    )
    return f"custom({body or 'hbm_resident'})"


def policy(
    name: str | None = None,
    description: str = "",
    **role_placements: "str | Placement",
) -> PlacementPolicy:
    """Compositional policy constructor: placements as values, not names::

        policy(kv="host:stream", params="peer_hbm")

    Unnamed policies get a stable derived name so they serialize, log and
    register cleanly.
    """
    placements = {
        parse_role(role): Placement.parse(pl)
        for role, pl in role_placements.items()
    }
    return PlacementPolicy(name or _spec_name(placements), placements,
                           description)


class PolicyBuilder:
    """Incremental form of :func:`policy` for programmatic construction::

        p = (PolicyBuilder("serve_spill")
             .place("kv_cache", "host:stream")
             .place(Role.PARAMS, Placement(MemoryTier.PEER_HBM))
             .describe("KV spilled to host, params on the donor")
             .build())

    ``build(register=True)`` also publishes it to the registry.
    """

    def __init__(self, name: str | None = None):
        self._name = name
        self._description = ""
        self._placements: dict[Role, Placement] = {}

    def place(self, role: "str | Role", placement: "str | Placement") -> "PolicyBuilder":
        self._placements[parse_role(role)] = Placement.parse(placement)
        return self

    def describe(self, description: str) -> "PolicyBuilder":
        self._description = description
        return self

    def build(self, *, register: bool = False) -> PlacementPolicy:
        out = PlacementPolicy(
            self._name or _spec_name(self._placements),
            dict(self._placements),
            self._description,
        )
        if register:
            register_policy(out)
        return out


def parse_policy(text: "str | Mapping | PlacementPolicy") -> PlacementPolicy:
    """One entry point for every external policy spelling.

    Accepts, in order: a :class:`PlacementPolicy` (pass-through), a
    registered policy name (``"kv_host"``), a JSON object/string
    (:meth:`PlacementPolicy.from_json`), or the compact grammar
    (``"kv=host:stream,params=peer_hbm"``).
    """
    if isinstance(text, PlacementPolicy):
        return text
    if isinstance(text, Mapping):
        return PlacementPolicy.from_json(text)
    text = text.strip()
    if text in _REGISTRY:
        return _REGISTRY[text]
    if text.startswith("{"):
        return PlacementPolicy.from_json(text)
    if "=" not in text:
        raise ValueError(
            f"unknown policy {text!r}: not a registered name "
            f"({sorted(_REGISTRY)}), not JSON, and not the "
            "role=tier[:strategy][,...] grammar"
        )
    placements: dict[Role, Placement] = {}
    for part in text.split(","):
        if not part.strip():
            continue
        role_s, eq, pl_s = part.partition("=")
        if not eq:
            raise ValueError(
                f"bad policy fragment {part!r} in {text!r} "
                "(expected role=tier[:strategy])"
            )
        if role_s.strip().lower() == "pools":
            raise ValueError(
                f"policy spec {text!r} carries a 'pools=' directive; the "
                "disaggregated-serve pool split is not ported yet "
                "(ROADMAP A13)"
            )
        placements[parse_role(role_s)] = Placement.parse(pl_s)
    return PlacementPolicy(_spec_name(placements), placements,
                           "parsed from policy spec string")


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, PlacementPolicy] = {}


def register_policy(
    policy: PlacementPolicy, *, overwrite: bool = False
) -> PlacementPolicy:
    """Publish ``policy`` under its name.

    Registered policies show up everywhere the registry is enumerated:
    planner candidate sets and the benchmark policy tables.  Re-registering
    a name is an error unless ``overwrite=True`` (a silent replacement
    would change what existing configs mean).
    """
    if not policy.name:
        raise ValueError("cannot register an unnamed policy")
    if policy.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"policy {policy.name!r} is already registered; pass "
            "overwrite=True to replace it"
        )
    _REGISTRY[policy.name] = policy
    return policy


def get_policy(name: str) -> PlacementPolicy:
    """Registered policy by exact name (KeyError lists what exists)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no registered placement policy {name!r}; registered: "
            f"{sorted(_REGISTRY)}"
        ) from None


def registered_policies() -> dict[str, PlacementPolicy]:
    """Snapshot of the registry (insertion-ordered name -> policy)."""
    return dict(_REGISTRY)


def _policy(name: str, desc: str, **roles: Placement) -> PlacementPolicy:
    return register_policy(PlacementPolicy(
        name,
        {Role[k.upper()]: v for k, v in roles.items()},
        desc,
    ))


HOST_STREAM = Placement(MemoryTier.HOST, Strategy.STREAM)
PEER_HBM = Placement(MemoryTier.PEER_HBM, Strategy.RESIDENT)
PEER_HBM_STREAM = Placement(MemoryTier.PEER_HBM, Strategy.STREAM)
PEER_HOST_STREAM = Placement(MemoryTier.PEER_HOST, Strategy.STREAM)
REMOTE_HBM = Placement(MemoryTier.REMOTE_HBM, Strategy.RESIDENT)


#: Paper-faithful default: everything in fast memory ("local HBM" column of
#: every paper figure — the best-performing placement when it fits).
HBM_RESIDENT = _policy(
    "hbm_resident",
    "all tensors in device HBM (paper's local-HBM baseline)",
)

#: Optimizer-state offload: master weights + moments live in host DRAM and
#: are streamed through once per step (ZeRO-Offload-style).
OPT_HOST = _policy(
    "opt_host",
    "Adam moments + f32 master in host DRAM, streamed once per step",
    master=HOST_STREAM,
    opt_state=HOST_STREAM,
)

#: KV cache on host, streamed per decode step (paper Fig. 17's DDR rows).
KV_HOST = _policy(
    "kv_host",
    "KV cache in host DRAM, streamed per decode step",
    kv_cache=HOST_STREAM,
)

#: Layer-wise weight streaming (paper Fig. 17 'weights on DDR').
WEIGHTS_STREAM = _policy(
    "weights_stream",
    "weights resident in host DRAM, streamed layer-by-layer",
    params=HOST_STREAM,
)

#: KV cache in a peer card's HBM, read in place over the card-to-card
#: link — the paper's HBM-p column.
KV_PEER_HBM = _policy(
    "kv_peer_hbm",
    "KV cache resident in a peer chip's HBM, read in place over ICI",
    kv_cache=PEER_HBM,
)

#: Weights streamed from a peer card's HBM (Figs. 15-16: GEMM sources in
#: HBM-p).
WEIGHTS_PEER_HBM = _policy(
    "weights_peer_hbm",
    "weights resident in peer HBM, streamed layer-by-layer over ICI",
    params=PEER_HBM_STREAM,
)

#: Optimizer state spilled to a *peer's* host DRAM (DDR-p column).
OPT_PEER_HOST = _policy(
    "opt_peer_host",
    "Adam moments + f32 master in a peer's host DRAM (spill-to-peer-host)",
    master=PEER_HOST_STREAM,
    opt_state=PEER_HOST_STREAM,
)

#: KV cache in a remote host's card memory over the inter-host network.
KV_REMOTE_HBM = _policy(
    "kv_remote_hbm",
    "KV cache resident in a remote pod's HBM, read in place over DCN",
    kv_cache=REMOTE_HBM,
)
