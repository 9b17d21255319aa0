"""Layered serve stack of the port: state / sampling / scheduler / engine.

- :mod:`repro_torch.serve.state` — slot host mirrors, device serve state,
  and the copying upload discipline.
- :mod:`repro_torch.serve.sampling` — per-request sampling computed on the
  device, with a NumPy oracle for the filter.
- :mod:`repro_torch.serve.scheduler` — the continuous-batching front end
  and the public :class:`Server`.
- :mod:`repro_torch.serve.engine` — the :class:`Executor`: chunked prefill
  and decode dispatches over an in-place KV cache.
"""

from repro_torch.serve.engine import Executor  # noqa: F401
from repro_torch.serve.sampling import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    QueueFullError,
    Request,
    ServeConfig,
    ServeHangError,
    Server,
)
