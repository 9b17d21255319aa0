"""The paper's measurement core for one H100.

Counterpart of ``repro/core``:

* :mod:`repro_torch.core.hardware`    — H100 card/host/system model (constants).
* :mod:`repro_torch.core.datapath`    — per-operation theoretical bounds (Fig. 3).
* :mod:`repro_torch.core.membench`    — paper-methodology measurement (CUDA events).
* :mod:`repro_torch.core.replay`      — predicted-vs-measured per calibrated term.
* :mod:`repro_torch.core.calibration` — measured terms from the card's own sweeps.

The placement planner, placement policies and the roofline reports are
not ported yet (ROADMAP A9).
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
from repro_torch.core.replay import (  # noqa: F401
    ReplayLog,
    ReplayRecord,
    TermError,
)
