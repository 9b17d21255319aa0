"""Placement policies: where every tensor role physically lives.

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

The realization half, on one device instead of a mesh: the local tiers a
card reaches are its own memory (``HBM``) and pinned host memory
(``HOST``).  :func:`host_available`, :func:`to_device` / :func:`to_host`
(a host tree is one :class:`HostArena`: pinned and mapped for a card,
plain memory for the CPU, where host memory *is* the device's),
:func:`place_tree` (a tree under a role's placement) and :class:`HostStream`
(the one-card counterpart of the reference's ``DonorStream``: windows of a
host-resident stack staged through ``depth`` device slots).  The
``Runtime`` (:mod:`repro_torch.api`) is their one user-facing owner.

What is left out, and why:

* the donor tiers' realization (``sharding``, ``DonorStream``): a peer or
  remote tier needs a donor mesh axis, which one card does not have, so a
  peer or remote placement is refused exactly as on a reference mesh
  without one;
* the memory-kind queries (``available_memory_kinds``,
  ``resolve_memory_kind``): JAX's memory kinds have no torch counterpart;
  a tensor is on the card or in host memory, pinned or not;
* ``PoolSplit``/``extract_pool_split``, the disaggregated-serve grammar
  (ROADMAP A13);
* the deprecated read-only view of the registry.

The reference's donor checks read ``mesh.shape``; the port has no device
mesh, so :func:`donor_axes_for`, :func:`donor_allow_flags` and
:func:`validate_policy_for_mesh` take a mapping of mesh axis names to sizes
(``None`` for no mesh).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import json
from typing import Mapping

import torch

from repro_torch.core.hardware import MemoryTier
from repro_torch.models.sharding import tree_leaves, tree_map


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


def host_available(device: str | torch.device | None = None) -> bool:
    """Is there a host tier distinct from ``device``'s memory?  True on a
    CUDA device (pinned host memory behind PCIe); False on the CPU, where
    host memory *is* the device's memory, and with no device at all
    (analysis only)."""
    return device is not None and torch.device(device).type == "cuda"


def donor_allow_flags(mesh_axes: Mapping[str, int] | None,
                      device: str | torch.device | None = None) -> dict[str, bool]:
    """``allow_*`` kwargs for :func:`repro_torch.core.planner.plan`: peer
    tiers need a :data:`DONOR_AXIS`, remote tiers a
    :data:`REMOTE_DONOR_AXIS`, host tiers a device with distinct host
    memory (:func:`host_available`)."""
    axes = _axes(mesh_axes)
    return {
        "allow_host": host_available(device),
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


def donation_compatible(policy: PlacementPolicy, role: Role) -> bool:
    """May a step update ``role``'s buffers in place under ``policy``
    (the reference's donation rule)?  Exactly for RESIDENT placements: a
    STREAM placement's host copy stays the source of truth while a step
    works on a staged window of it."""
    return policy.placement(role).strategy is not Strategy.STREAM


# ---------------------------------------------------------------------------
# Realization on one device: its memory and (pinned) host memory
# ---------------------------------------------------------------------------

#: byte alignment of each leaf in a host arena and a staging slot
_ALIGN = 256


def _layout(leaves) -> tuple[list[int], int]:
    """Aligned byte offsets of ``leaves`` packed one after another, and
    the total."""
    offsets, end = [], 0
    for t in leaves:
        offsets.append(end)
        end += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offsets, end


def _carve(base: torch.Tensor, offset: int, like: torch.Tensor) -> torch.Tensor:
    """A tensor shaped and typed like ``like`` over ``base``'s bytes at
    ``offset``."""
    n = like.numel() * like.element_size()
    return base[offset:offset + n].view(like.dtype).view(like.shape)


class HostArena:
    """One block of host memory that holds a tree's leaves.

    For a CUDA device the block is pinned and mapped for the card
    (:func:`~repro_torch.kernels.kv_stream.pinned_empty`: ``cudaHostAlloc``
    at its exact size) and freed with the last tensor over it; every leaf
    carved from it carries the arena.  For the CPU it is plain memory:
    host memory *is* the device's, so the arena only gives a host tree
    storage of its own.
    """

    def __init__(self, nbytes: int, device: torch.device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        if self.pinned:
            from repro_torch.kernels import kv_stream

            self.base = kv_stream.pinned_empty(nbytes)
        else:
            self.base = torch.empty(max(int(nbytes), 1), dtype=torch.uint8)

    def carve(self, offset: int, like: torch.Tensor) -> torch.Tensor:
        out = _carve(self.base, offset, like)
        out._host_arena = self
        return out

    def mapped(self) -> torch.Tensor:
        """The whole block as a ``uint8`` CUDA tensor, through the card's
        mapped view of it (:func:`~repro_torch.kernels.kv_stream.mapped`):
        what the card computes on in place.  The tensor and every view of
        it keep the block alive."""
        from repro_torch.kernels import kv_stream

        return kv_stream.mapped(self.base)


def host_empty(tree, device: str | torch.device):
    """Uninitialized host tensors shaped and typed like ``tree``'s leaves,
    in one :class:`HostArena` for ``device`` (pinned and mapped for a card;
    raises if a leaf does not land pinned there — never a pageable host
    buffer the card cannot stream from)."""
    device = torch.device(device)
    offsets, total = _layout(tree_leaves(tree))
    arena = HostArena(total, device)
    it = iter(offsets)
    out = tree_map(lambda t: arena.carve(next(it), t), tree)
    if arena.pinned and not all(t.is_pinned() for t in tree_leaves(out)):
        raise RuntimeError(f"host placement of {total} bytes did not land in "
                           "pinned host memory")
    return out


def to_host(tree, device: str | torch.device, *, mapped: bool = False):
    """A copy of ``tree`` in host memory for ``device``: one
    :class:`HostArena` (:func:`host_empty`), pinned and mapped when
    ``device`` is a card.  With ``mapped`` (a card only) the leaves
    returned are CUDA tensors over the card's mapped view of the arena,
    each carrying ``_host_arena``: kernels read and write them in place,
    over PCIe."""
    device = torch.device(device)
    out = host_empty(tree, device)
    leaves = tree_leaves(out)
    for dst, src in zip(leaves, tree_leaves(tree)):
        dst.copy_(src)
    if not mapped or not leaves:
        return out
    return mapped_tree(out)


def mapped_tree(tree):
    """The card's mapped view of a host tree that fills one pinned
    :class:`HostArena` (what :func:`host_empty` returns): CUDA tensors over
    the same bytes, each carrying ``_host_arena``, which kernels and
    PyTorch's operators read and write in place, over PCIe.  Raises for a
    CPU device's (unpinned) arena."""
    leaves = tree_leaves(tree)
    arena = leaves[0]._host_arena
    if not arena.pinned:
        raise ValueError(f"a mapped view of host memory is a card's; the device is "
                         f"{arena.device}")
    view, it = arena.mapped(), iter(_layout(leaves)[0])

    def carve(t):
        leaf = _carve(view, next(it), t)
        leaf._host_arena = arena
        return leaf

    return tree_map(carve, tree)


def to_device(tree, device: str | torch.device):
    """A copy of ``tree`` in ``device``'s memory, leaf by leaf."""
    device = torch.device(device)
    return tree_map(lambda t: t.to(device, copy=True).contiguous(), tree)


def host_bytes(tree) -> int:
    """Bytes of the tree's leaves (what a host copy of it holds)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def place_tree(tree, placement: Placement, device: str | torch.device):
    """``tree`` under ``placement`` for ``device``: in host memory for a
    host tier, in the device's memory for ``HBM``.  In host memory a
    RESIDENT placement on a card comes back as CUDA tensors over the
    card's mapped view of a pinned arena (the steps compute on it in
    place, over PCIe); a STREAM placement as the pinned host tensors a
    :class:`HostStream` stages window by window.  On the CPU both are
    plain host arenas.  Peer and remote tiers need a donor axis one device
    does not have (:class:`DonorAxisError`)."""
    device = torch.device(device)
    if placement.on_host:
        if placement.tier is not MemoryTier.HOST:
            donor_axes_for(None, placement.tier)
        return to_host(tree, device, mapped=device.type == "cuda"
                       and placement.strategy is Strategy.RESIDENT)
    if placement.tier is not MemoryTier.HBM:
        donor_axes_for(None, placement.tier)
    return to_device(tree, device)


#: how many window fetches a HostStream remembers, newest last
FETCH_LOG = 4096


class HostStream:
    """Windows of a host-resident tree, staged through device slots.

    The executable form of ``Strategy.STREAM`` from host memory on one
    device (the planner's ``copy_bound(HOST, HBM)``), and the one-card
    counterpart of the reference's ``DonorStream``.  ``windows`` is a list
    of trees of contiguous host tensors (:meth:`stacked` cuts a tree
    stacked on dim 0 into its slices).  :meth:`window` returns window
    ``i`` in device staging slot ``i % depth``, having already issued the
    copies of the next ``depth - 1`` windows behind it, so the next copy
    crosses PCIe while the caller computes on window ``i``.  At most
    ``depth`` windows are held on the device: the ``2 * bytes /
    stream_chunks`` staging footprint the planner charges to HBM for
    ``depth = 2`` (each slot is as large as the largest window).

    On a card the copies run on a copy stream of their own.  A copy into
    a slot waits on an event recorded on the caller's stream when it was
    issued, which is after the last read of that slot's previous window
    (window ``i - 1`` is consumed before window ``i`` is asked for);
    :meth:`window` makes the caller's stream wait for its window's copy.
    Work queued inside :meth:`writing_back` (the KV write-back kernel of a
    layer) runs on a write-back stream of its own, after the caller's
    work so far, and the copy that refills that window's slot waits for
    it too.  :meth:`finish` joins both streams back into the caller's, so
    a step that streams can be captured in a CUDA graph (the copies go
    through ``cudaMemcpyAsync`` on pinned memory).  :meth:`write_back`
    copies a window's slot back into host memory (the updated optimizer
    state, a training step's new params).  :meth:`stage` hands out a
    window's slot without copying into it, for a window the caller only
    writes and then writes back; the caller's writes into it wait for the
    slot's last write-back.  On the CPU the copies are plain synchronous
    copies between host tensors, so the window logic runs there too.

    A sweep runs forward (``begin()``: window ``i`` prefetches ``i + 1``)
    or in reverse (``begin(reverse=True)``: window ``i`` prefetches ``i -
    1``, a training step's backward, last layer first).  ``slots`` shares
    the staging slots of another stream over the same host tree (a
    training step's params update writes back through the slots its
    forward and backward staged in); the two must not be mid-sweep at the
    same time.
    """

    def __init__(self, windows: list, device: str | torch.device, depth: int = 2,
                 *, slots: list[torch.Tensor] | None = None):
        if not windows:
            raise ValueError("a HostStream needs at least one window")
        self.windows = windows
        self.n_windows = len(windows)
        self.depth = max(int(depth), 2)
        self.device = torch.device(device)
        self._leaves = [tree_leaves(w) for w in windows]
        layouts = [_layout(ls) for ls in self._leaves]
        self._offsets = [o for o, _ in layouts]
        self.slot_bytes = max(n for _, n in layouts)
        if slots is None:
            slots = [torch.empty(max(self.slot_bytes, 1), dtype=torch.uint8,
                                 device=self.device) for _ in range(self.depth)]
        elif len(slots) != self.depth or any(s.numel() < self.slot_bytes for s in slots):
            raise ValueError(f"{len(slots)} shared slots of {[s.numel() for s in slots]} "
                             f"bytes for {self.depth} slots of {self.slot_bytes}")
        self._slots = list(slots)
        #: whether the current sweep runs last window first
        self.reverse = False
        self._views: dict[tuple[int, int], object] = {}
        #: window index -> slot, for the windows staged now
        self._held: dict[int, int] = {}
        #: window indices in the order their copies were issued (the last
        #: FETCH_LOG of them)
        self.fetches: collections.deque[int] = collections.deque(maxlen=FETCH_LOG)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            from repro_torch.kernels import kv_stream

            for w, ls in enumerate(self._leaves):
                for t in ls:
                    if not (t.device.type == "cpu" and t.is_contiguous()
                            and t.is_pinned()):
                        raise ValueError(
                            f"window {w}: a HostStream streams contiguous pinned "
                            f"host tensors, got one on {t.device} (pinned: "
                            f"{t.device.type == 'cpu' and t.is_pinned()})")
            self._copy = kv_stream.copy_async
            self._copy_stream = torch.cuda.Stream(self.device)
            self._ready = [torch.cuda.Event() for _ in range(self.depth)]
            self._wb_stream = torch.cuda.Stream(self.device)
            #: per slot, the end of the write-back of the window it holds
            self._read = [torch.cuda.Event() for _ in range(self.depth)]
            #: per slot, the end of the last copy of it back to host memory
            self._drained = [torch.cuda.Event() for _ in range(self.depth)]
        #: per slot, whether this step queued a write-back that reads it
        self._reading = [False] * self.depth
        #: whether the write-back stream has work finish() has not joined
        self._wb_pending = False

    @classmethod
    def stacked(cls, tree, n_windows: int, device, depth: int = 2) -> "HostStream":
        """Windows ``tree[i]`` (every leaf sliced on dim 0), ``i <
        n_windows``."""
        for t in tree_leaves(tree):
            if t.shape[0] != n_windows:
                raise ValueError(f"leaf of shape {tuple(t.shape)} is not stacked "
                                 f"{n_windows} deep on dim 0")
        return cls([tree_map(lambda t: t[i], tree) for i in range(n_windows)],
                   device, depth)

    @property
    def window_bytes(self) -> list[int]:
        """Bytes each window moves from host memory."""
        return [sum(t.numel() * t.element_size() for t in ls) for ls in self._leaves]

    def _view(self, slot: int, i: int):
        key = (slot, i)
        if key not in self._views:
            it = iter(self._offsets[i])
            self._views[key] = tree_map(
                lambda t: _carve(self._slots[slot], next(it), t), self.windows[i])
        return self._views[key]

    def _fetch(self, j: int) -> None:
        slot = j % self.depth
        self._held[j] = slot
        self.fetches.append(j)
        staged = tree_leaves(self._view(slot, j))
        if not self._cuda:
            for dst, src in zip(staged, self._leaves[j]):
                dst.copy_(src)
            return
        # the slot's previous window was consumed before this call, by the
        # caller's stream and by its write-back
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        if self._reading[slot]:
            self._copy_stream.wait_event(self._read[slot])
            self._reading[slot] = False
        for dst, src in zip(staged, self._leaves[j]):
            self._copy(dst, src, self._copy_stream)
        self._ready[slot].record(self._copy_stream)

    def begin(self, reverse: bool = False) -> None:
        """Forget what is staged: the next :meth:`window` copies afresh
        (a step, or a sweep of it, starts; its windows are read from host
        memory again).  ``reverse``: the sweep asks for its windows last
        first, and each prefetches the one before it."""
        self._held.clear()
        self._reading = [False] * self.depth   # the last step's finish joined them
        self.reverse = bool(reverse)

    def window(self, i: int):
        """Window ``i`` in device memory; the copies of the next ``depth -
        1`` windows of the sweep (after ``i``, or before it in reverse)
        are issued behind it."""
        if not 0 <= i < self.n_windows:
            raise IndexError(f"window {i} of {self.n_windows}")
        keep = (range(i, max(i - self.depth, -1), -1) if self.reverse
                else range(i, min(i + self.depth, self.n_windows)))
        for k in [k for k in self._held if k not in keep]:
            del self._held[k]          # its slot is free for a prefetch
        for j in keep:                 # j == i first: the caller's window
            if j not in self._held:
                self._fetch(j)
        slot = self._held[i]
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(self._ready[slot])
        return self._view(slot, i)

    def stage(self, i: int):
        """Window ``i``'s slot in device memory, nothing copied into it: for
        a window the caller fills and then :meth:`write_back` s.  The
        caller's stream waits for the slot's last copy back to host
        memory before it may write the slot."""
        if not 0 <= i < self.n_windows:
            raise IndexError(f"window {i} of {self.n_windows}")
        slot = i % self.depth
        for k in [k for k, s in self._held.items() if s == slot]:
            del self._held[k]
        self._held[i] = slot
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(self._drained[slot])
        return self._view(slot, i)

    @contextlib.contextmanager
    def writing_back(self, i: int):
        """A context whose work (it reads window ``i``'s slot) runs on the
        write-back stream, after the caller's stream's work so far; the
        copy that next refills the slot waits for it, and :meth:`finish`
        joins it.  On the CPU the work runs in place."""
        if not self._cuda:
            yield
            return
        slot = self._held[i]
        self._wb_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._wb_stream):
            yield
        self._read[slot].record(self._wb_stream)
        self._reading[slot] = True
        self._wb_pending = True

    def write_back(self, i: int, part=None) -> None:
        """Copy window ``i``'s slot, as the caller's stream has left it,
        back into its host tensors: the whole window, or only its entry
        ``part`` (a top-level key of the window's tree), one copy a leaf."""
        slot = self._held[i]
        host, staged = self.windows[i], self._view(slot, i)
        if part is not None:
            host, staged = host[part], staged[part]
        pairs = list(zip(tree_leaves(host), tree_leaves(staged)))
        if not self._cuda:
            for dst, src in pairs:
                dst.copy_(src)
            return
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        for dst, src in pairs:
            self._copy(dst, src, self._copy_stream)
        self._drained[slot].record(self._copy_stream)

    def finish(self) -> None:
        """Join the copy stream, and the write-back stream when this step
        used it, back into the caller's stream."""
        if self._cuda:
            caller = torch.cuda.current_stream(self.device)
            caller.wait_stream(self._copy_stream)
            if self._wb_pending:
                caller.wait_stream(self._wb_stream)
                self._wb_pending = False

    def buffers(self) -> list[torch.Tensor]:
        """The device staging slots (fixed for the stream's life)."""
        return list(self._slots)
