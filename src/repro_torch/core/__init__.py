"""The paper's measurement core for one H100.

Counterpart of ``repro/core``:

* :mod:`repro_torch.core.hardware`    — H100 card/host/system model (constants).
* :mod:`repro_torch.core.datapath`    — per-operation theoretical bounds (Fig. 3).
* :mod:`repro_torch.core.membench`    — paper-methodology measurement (CUDA events).
* :mod:`repro_torch.core.replay`      — predicted-vs-measured per calibrated term.
* :mod:`repro_torch.core.calibration` — measured terms from the card's own sweeps.
* :mod:`repro_torch.core.placement`   — per-role memory placement policies,
  and their realization on one device (pinned host arenas, ``HostStream``).
* :mod:`repro_torch.core.planner`     — policy selection from predicted step time.
* :mod:`repro_torch.core.op_analysis` — a step's FLOPs and bytes counted op by
  op on ``meta`` (the reference's HLO analyzer).
* :mod:`repro_torch.core.roofline`    — the three-term roofline of a counted step.

The ``Runtime`` that owns them is :mod:`repro_torch.api`.  The donor
tiers' realization needs a donor axis (ROADMAP A10c).
"""

from repro_torch.core.hardware import (  # noqa: F401
    AXIS_LINK,
    CALIBRATED_TERMS,
    ChipSpec,
    Link,
    MemoryTier,
    PodSpec,
    SystemSpec,
    axis_bandwidth,
    get_active_system,
    link_for_axis,
    set_active_system,
)
from repro_torch.core.datapath import (  # noqa: F401
    Bound,
    bound_matrix,
    collective_bound,
    copy_bound,
    migration_crossover_touches,
    read_bound,
    streaming_time,
    wire_bytes,
    write_bound,
)
from repro_torch.core.placement import (  # noqa: F401
    DONOR_AXIS,
    HBM_RESIDENT,
    KV_HOST,
    KV_PEER_HBM,
    KV_REMOTE_HBM,
    OPT_HOST,
    OPT_PEER_HOST,
    REMOTE_DONOR_AXIS,
    WEIGHTS_PEER_HBM,
    WEIGHTS_STREAM,
    DonorAxisError,
    Placement,
    PlacementPolicy,
    PolicyBuilder,
    Role,
    Strategy,
    donor_allow_flags,
    donor_axes_for,
    get_policy,
    parse_policy,
    policy,
    register_policy,
    registered_policies,
    validate_policy_for_mesh,
)
from repro_torch.core.planner import (  # noqa: F401
    CollectiveTerm,
    PlacementOOMError,
    PolicyPrediction,
    WorkloadProfile,
    decode_profile,
    eligible_policies,
    plan,
    pool_capacities,
    predict,
    train_profile,
)
from repro_torch.core.replay import (  # noqa: F401
    ReplayLog,
    ReplayRecord,
    TermError,
)
