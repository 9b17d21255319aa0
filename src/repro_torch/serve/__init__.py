"""Layered serve stack of the port: state / sampling / scheduler / engine.

- :mod:`repro_torch.serve.state` — slot host mirrors, device serve state,
  the copying upload discipline, and the spill record of a preempted
  request.
- :mod:`repro_torch.serve.sampling` — per-request sampling computed on the
  device, with a NumPy oracle for the filter.
- :mod:`repro_torch.serve.scheduler` — the continuous-batching front end
  (queue, preemption, recovery, watchdog), the public :class:`Server` and
  the asyncio :class:`Scheduler`.
- :mod:`repro_torch.serve.engine` — the :class:`Executor`: chunked prefill
  and decode dispatches over an in-place KV cache, slot extract/insert,
  replan and evacuate.
"""

from repro_torch.serve.engine import Executor  # noqa: F401
from repro_torch.serve.sampling import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    QueueFullError,
    Request,
    Scheduler,
    SchedulerClosed,
    ServeConfig,
    ServeHangError,
    Server,
)
from repro_torch.serve.state import SlotTable, SpilledSequence  # noqa: F401
