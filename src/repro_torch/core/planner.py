"""Placement planner: pick the placement policy the datapath model favors.

Counterpart of ``repro/core/planner.py``, copied whole but for the
disaggregated-serve pool split (``PoolSplitPrediction``/``plan_pool_split``,
ROADMAP A13): the same profiles, policies and :class:`SystemSpec` values
give the same predictions and picks.

This automates the paper's §IV decision: given a workload's per-step byte
traffic per tensor role and the capacity of each memory pool, predict the
step time of every placement policy **from the datapath bounds** and choose
the fastest one that *fits*.  Every bandwidth/latency term is derived from
:mod:`repro_torch.core.datapath` ``Bound`` objects — ``read_bound`` for
in-place accesses, ``copy_bound`` for streamed migrations (inheriting the
twice-traversed-link halving rule and per-segment latencies), and
``collective_bound`` for collective terms.  The planner covers the full
:class:`~repro_torch.core.hardware.MemoryTier` axis (local HBM and host
DRAM, a peer card's HBM/DRAM over NVLink, a remote card's HBM over the
inter-host network — the paper's HBM/DDR/HBM-p/DDR-p columns) and
accounts capacity per *pool*: local HBM (including the double-buffered
staging window a streamed tensor occupies), local host DRAM, and the
peer/remote donor pools, each one donor's full pool.

Callers derive the ``allow_*`` gates from what they can realize
(:func:`repro_torch.core.placement.donor_allow_flags`).  When nothing
fits, :func:`plan` either degrades to the smallest-HBM policy (default) or,
with ``require_fit=True``, raises :class:`PlacementOOMError` reporting the
overflow of every memory pool per policy.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from repro_torch.core.datapath import (
    Bound,
    collective_bound,
    copy_bound,
    read_bound,
)
from repro_torch.core.hardware import Link, MemoryTier, SystemSpec, get_active_system
from repro_torch.core.placement import (
    HOST_TIERS,
    PlacementPolicy,
    Role,
    Strategy,
    registered_policies,
)

#: capacity pool each tier's bytes are charged to
_TIER_POOL: dict[MemoryTier, str] = {
    MemoryTier.HBM: "hbm",
    MemoryTier.HOST: "host",
    MemoryTier.PEER_HBM: "peer_hbm",
    MemoryTier.PEER_HOST: "peer_host",
    MemoryTier.REMOTE_HBM: "remote_hbm",
}

#: which serialized-transfer bucket a bound's limiting link belongs to.
#: (HBM_BUS-limited transfers fold into the hbm term: they contend with
#: the compute pass for the same bus.)
_LINK_BUCKET: dict[Link, str] = {
    Link.PCIE: "pcie",
    Link.ICI: "ici",
    Link.DCN: "dcn",
    Link.HBM_BUS: "hbm",
    Link.VMEM_BUS: "hbm",
}


def pool_capacities(system: SystemSpec | None = None) -> dict[str, float]:
    """Capacity of every memory pool the planner accounts, in bytes."""
    system = system if system is not None else get_active_system()
    chip = system.chip
    return {
        "hbm": chip.hbm_capacity,
        "host": chip.host_dram_capacity,
        "peer_hbm": chip.hbm_capacity,          # one donor chip's HBM
        "peer_host": chip.host_dram_capacity,   # one donor host's DRAM
        "remote_hbm": chip.hbm_capacity,        # one remote chip's HBM
    }


@dataclasses.dataclass(frozen=True)
class CollectiveTerm:
    """One collective the step must run, timed via ``collective_bound``."""

    kind: str            # 'all_reduce' | 'all_gather' | ... (datapath kinds)
    link: Link           # the mesh axis's physical link (ICI or DCN)
    axis_size: int
    payload_bytes: float  # per-chip payload as collective_bound defines it

    def seconds(self, system: SystemSpec | None = None) -> float:
        bw = collective_bound(self.axis_size, self.link, self.kind, system)
        return self.payload_bytes / bw if bw != float("inf") else 0.0


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-chip, per-step workload description.

    ``bytes_per_role``: resident size of each role's tensors (per chip).
    ``touches_per_role``: how many times the role's bytes move through the
    compute datapath per step (params: 1 fwd read (+1 bwd read under remat);
    opt state: 1 read + 1 write; KV: 1 read per decoded token; ...).
    ``stream_chunks``: granularity of a streamed tensor's migration (layer
    count for layer-wise streaming) — sets both the per-touch latency count
    and the HBM staging-buffer footprint (double-buffered chunks).
    ``collectives``: collective terms timed via ``collective_bound``;
    ``collective_s`` adds pre-computed seconds (e.g. from a measured trace).
    """

    name: str
    flops: float
    bytes_per_role: Mapping[Role, float]
    touches_per_role: Mapping[Role, float]
    collective_s: float = 0.0
    collectives: tuple[CollectiveTerm, ...] = ()
    overlap_streams: bool = True   # host DMA overlaps compute (LHS scheduler)
    stream_chunks: int = 8


@dataclasses.dataclass
class PolicyPrediction:
    """Predicted step time + pool residency of one policy.

    Every ``*_s`` term except ``compute_s`` is datapath-bound-derived;
    ``limiting`` names the argmax term (the paper's bottleneck attribution).
    """

    policy: str
    fits: bool
    hbm_bytes: float               # local HBM pool, staging included
    host_bytes: float              # local host-DRAM pool
    bytes_by_pool: dict[str, float]
    overflow_pools: tuple[str, ...]
    compute_s: float
    hbm_s: float                   # local HBM-bus seconds
    pcie_s: float                  # PCIe-limited transfer seconds
    ici_s: float                   # ICI-limited transfer seconds
    dcn_s: float                   # DCN-limited transfer seconds
    collective_s: float
    step_s: float
    limiting: str

    def explain(self) -> str:
        pools = " ".join(
            f"{k} {v/2**30:.2f}GiB"
            for k, v in sorted(self.bytes_by_pool.items())
            if v > 0
        )
        return (
            f"{self.policy}: step={self.step_s*1e3:.3f} ms "
            f"[compute {self.compute_s*1e3:.3f} | hbm {self.hbm_s*1e3:.3f} "
            f"| pcie {self.pcie_s*1e3:.3f} | ici {self.ici_s*1e3:.3f} "
            f"| dcn {self.dcn_s*1e3:.3f} | coll {self.collective_s*1e3:.3f}] "
            f"limited by {self.limiting}; {pools}"
            + (
                ""
                if self.fits
                else f"  ** DOES NOT FIT: {', '.join(self.overflow_pools)} **"
            )
        )


def _touch_seconds(bound: Bound, nbytes: float, transfers: float) -> float:
    """Seconds for one touch moving ``nbytes`` in ``transfers`` pieces."""
    return nbytes / bound.bandwidth + transfers * bound.latency


def predict(
    profile: WorkloadProfile,
    policy: PlacementPolicy,
    system: SystemSpec | None = None,
) -> PolicyPrediction:
    """Predict ``policy``'s step time for ``profile`` from datapath bounds.

    Per role: HBM-resident bytes pay ``touches`` passes over the HBM read
    bound; streamed bytes pay ``touches`` migrations through
    ``copy_bound(tier, HBM)`` (halving rule + latency per chunk) *plus* the
    HBM pass, and occupy a double-buffered staging window in local HBM;
    far-tier-resident bytes pay ``touches`` in-place passes over the tier's
    ``read_bound``.  Transfer seconds are bucketed by each bound's limiting
    link; collective terms come from ``collective_bound``.
    """
    system = system if system is not None else get_active_system()
    chip = system.chip
    compute_s = profile.flops / chip.peak_bf16_flops

    hbm_read = read_bound(MemoryTier.HBM, system)
    chunks = max(int(profile.stream_chunks), 1)

    pools: dict[str, float] = {k: 0.0 for k in pool_capacities(system)}
    buckets = {"hbm": 0.0, "pcie": 0.0, "ici": 0.0, "dcn": 0.0}

    for role, nbytes in profile.bytes_per_role.items():
        touches = profile.touches_per_role.get(role, 1.0)
        pl = policy.placement(role)
        pool = _TIER_POOL[pl.tier]

        if pl.tier == MemoryTier.HBM:
            pools["hbm"] += nbytes
            buckets["hbm"] += touches * _touch_seconds(hbm_read, nbytes, 1)
        elif pl.strategy == Strategy.STREAM:
            # lives in the far tier; each touch is one chunked bulk
            # migration over the copy datapath plus one HBM compute pass,
            # through a double-buffered staging window in local HBM.
            pools[pool] += nbytes
            pools["hbm"] += 2.0 * nbytes / chunks
            cb = copy_bound(pl.tier, MemoryTier.HBM, system)
            buckets[_LINK_BUCKET[cb.limiting_link]] += (
                touches * _touch_seconds(cb, nbytes, chunks)
            )
            buckets["hbm"] += touches * _touch_seconds(hbm_read, nbytes, 1)
        else:
            # resident in a far tier, accessed in place — every touch
            # crosses the tier's full read datapath.
            pools[pool] += nbytes
            rb = read_bound(pl.tier, system)
            buckets[_LINK_BUCKET[rb.limiting_link]] += (
                touches * _touch_seconds(rb, nbytes, 1)
            )

    coll_s = profile.collective_s + sum(
        term.seconds(system) for term in profile.collectives
    )

    terms = {
        "compute": compute_s,
        "hbm": buckets["hbm"],
        "pcie": buckets["pcie"],
        "ici": buckets["ici"],
        "dcn": buckets["dcn"],
        "collective": coll_s,
    }
    if profile.overlap_streams:
        step_s = max(terms.values())
    else:
        step_s = (
            max(compute_s, buckets["hbm"])
            + buckets["pcie"] + buckets["ici"] + buckets["dcn"] + coll_s
        )
    limiting = max(terms, key=terms.get)

    caps = pool_capacities(system)
    overflow = tuple(
        k for k, v in pools.items() if v > caps[k]
    )

    return PolicyPrediction(
        policy=policy.name,
        fits=not overflow,
        hbm_bytes=pools["hbm"],
        host_bytes=pools["host"],
        bytes_by_pool=dict(pools),
        overflow_pools=overflow,
        compute_s=compute_s,
        hbm_s=buckets["hbm"],
        pcie_s=buckets["pcie"],
        ici_s=buckets["ici"],
        dcn_s=buckets["dcn"],
        collective_s=coll_s,
        step_s=step_s,
        limiting=limiting,
    )


def eligible_policies(
    policies: Iterable[PlacementPolicy] | None = None,
    *,
    allow_host: bool = True,
    allow_peer: bool = True,
    allow_remote: bool = True,
) -> list[PlacementPolicy]:
    """Filter policies to tiers the runtime can actually reach.

    ``allow_host=False`` when the caller cannot place a tensor in host
    memory; ``allow_peer``/``allow_remote`` track whether the mesh has
    the donor axis that realizes those tiers (``donor`` on ICI /
    ``donor_pod`` on DCN) —
    :func:`repro_torch.core.placement.donor_allow_flags` derives all
    three.
    """
    out = []
    # note: an explicitly empty candidate list must stay empty (-> the
    # 'no eligible placement policies' error), not widen to the registry
    candidates = (
        registered_policies().values() if policies is None else policies
    )
    for p in candidates:
        tiers = p.tiers()
        if not allow_host and tiers & HOST_TIERS:
            continue
        if not allow_peer and tiers & {
            MemoryTier.PEER_HBM, MemoryTier.PEER_HOST
        }:
            continue
        if not allow_remote and MemoryTier.REMOTE_HBM in tiers:
            continue
        out.append(p)
    return out


class PlacementOOMError(RuntimeError):
    """No eligible policy fits; carries the per-pool overflow report."""

    def __init__(self, preds: list[PolicyPrediction],
                 system: SystemSpec | None = None):
        self.predictions = preds
        caps = pool_capacities(system)
        lines = []
        for p in preds:
            over = ", ".join(
                f"{pool} {p.bytes_by_pool[pool]/2**30:.2f}GiB "
                f"> cap {caps[pool]/2**30:.2f}GiB"
                for pool in p.overflow_pools
            )
            lines.append(f"  {p.policy}: {over}")
        super().__init__(
            "no placement policy fits every memory pool:\n" + "\n".join(lines)
        )


def plan(
    profile: WorkloadProfile,
    policies: Iterable[PlacementPolicy] | None = None,
    system: SystemSpec | None = None,
    *,
    allow_host: bool = True,
    allow_peer: bool = True,
    allow_remote: bool = True,
    require_fit: bool = False,
) -> tuple[PolicyPrediction, list[PolicyPrediction]]:
    """Evaluate eligible policies; return (best-feasible, all-predictions).

    Best = min step time among policies whose every pool fits; if none fit,
    the one with the smallest local-HBM residency (degraded but runnable) —
    mirroring the paper's observation that a slower placement that *runs*
    beats an OOM.  ``require_fit=True`` turns that fallback into a
    :class:`PlacementOOMError` whose message reports, per policy, every
    pool that overflows and by how much.
    """
    preds = [
        predict(profile, p, system)
        for p in eligible_policies(
            policies,
            allow_host=allow_host,
            allow_peer=allow_peer,
            allow_remote=allow_remote,
        )
    ]
    if not preds:
        raise ValueError("no eligible placement policies")
    feasible = [p for p in preds if p.fits]
    if feasible:
        best = min(feasible, key=lambda p: p.step_s)
    elif require_fit:
        raise PlacementOOMError(preds, system)
    else:
        best = min(preds, key=lambda p: p.hbm_bytes)
    return best, preds


# ---------------------------------------------------------------------------
# Profile builders for the framework's own workloads
# ---------------------------------------------------------------------------

def train_profile(
    *,
    name: str,
    param_bytes: float,
    step_flops: float,
    activation_bytes: float,
    collective_s: float = 0.0,
    num_chips: int = 1,
    remat: bool = True,
    n_layers: int = 8,
    data_axis_size: int = 1,
    pod_axis_size: int = 1,
) -> WorkloadProfile:
    """Per-chip training-step profile from global model numbers.

    Adam: master (4B/param as f32 vs 2B resident bf16 params -> x2 params
    bytes), moments 2 x 4B/param; grads 2B/param.  When the mesh has a
    data (ICI) or pod (DCN) axis, the per-step gradient all-reduce is added
    as a ``CollectiveTerm`` so ``collective_bound`` prices it.
    """
    p = param_bytes / num_chips
    act = activation_bytes / num_chips
    collectives = []
    # The gradient buffer is sharded over the model axis only and
    # replicated over data AND pod (that replication is what the data/pod
    # all-reduces resolve), so the per-chip payload of BOTH reductions is
    # param_bytes / model_size = p * data_axis_size * pod_axis_size.
    grad_payload = p * data_axis_size * pod_axis_size
    if data_axis_size > 1:
        collectives.append(
            CollectiveTerm("all_reduce", Link.ICI, data_axis_size, grad_payload)
        )
    if pod_axis_size > 1:
        collectives.append(
            CollectiveTerm("all_reduce", Link.DCN, pod_axis_size, grad_payload)
        )
    return WorkloadProfile(
        name=name,
        flops=step_flops / num_chips,
        bytes_per_role={
            Role.PARAMS: p,
            Role.MASTER: 2.0 * p,
            Role.OPT_STATE: 4.0 * p,
            Role.GRADS: p,
            Role.ACTIVATIONS: act,
        },
        touches_per_role={
            Role.PARAMS: 3.0 if remat else 2.0,  # fwd + bwd (+ remat fwd)
            Role.MASTER: 2.0,                    # read + write
            Role.OPT_STATE: 2.0,
            Role.GRADS: 2.0,
            Role.ACTIVATIONS: 2.0,
        },
        collective_s=collective_s,
        collectives=tuple(collectives),
        stream_chunks=max(int(n_layers), 1),
    )


def decode_profile(
    *,
    name: str,
    param_bytes: float,
    kv_bytes: float,
    step_flops: float,
    collective_s: float = 0.0,
    num_chips: int = 1,
    n_layers: int = 8,
) -> WorkloadProfile:
    """Per-chip single-token decode profile (paper Fig. 17 regime):
    reads all params + all KV once per token."""
    return WorkloadProfile(
        name=name,
        flops=step_flops / num_chips,
        bytes_per_role={
            Role.PARAMS: param_bytes / num_chips,
            Role.KV_CACHE: kv_bytes / num_chips,
        },
        touches_per_role={Role.PARAMS: 1.0, Role.KV_CACHE: 1.0},
        collective_s=collective_s,
        stream_chunks=max(int(n_layers), 1),
    )


def prefill_profile(
    *,
    name: str,
    param_bytes: float,
    kv_bytes: float,
    chunk_flops: float,
    activation_bytes: float = 0.0,
    collective_s: float = 0.0,
    num_chips: int = 1,
    n_layers: int = 8,
) -> WorkloadProfile:
    """Per-chip chunked-prefill profile (one batched admission dispatch).

    The serve engine writes whole prompt chunks per dispatch instead of
    replaying tokens through decode steps, so per chunk the params move
    through the datapath once, and the KV role is touched ~once: the chunk
    appends its keys (a write of ``chunk/max_len`` of the cache) and reads
    the prior cache, which over a full prompt averages half the final
    cache per chunk — together one cache-sized pass through whatever
    datapath (HBM bus, PCIe stream, donor link) the policy places the
    cache behind.  Capacity-wise prefill peaks *above* decode by the
    chunk's activations, so a policy must fit this profile too before the
    engine adopts it.
    """
    return WorkloadProfile(
        name=name,
        flops=chunk_flops / num_chips,
        bytes_per_role={
            Role.PARAMS: param_bytes / num_chips,
            Role.KV_CACHE: kv_bytes / num_chips,
            Role.ACTIVATIONS: activation_bytes / num_chips,
        },
        touches_per_role={
            Role.PARAMS: 1.0,
            Role.KV_CACHE: 1.0,
            Role.ACTIVATIONS: 2.0,   # written by the chunk, read back
        },
        collective_s=collective_s,
        stream_chunks=max(int(n_layers), 1),
    )
