from repro_torch.runtime.retry import (  # noqa: F401
    CHECKPOINT_RETRY,
    DEFAULT_RETRY,
    RetryBudgetExceeded,
    RetryPolicy,
    retry_call,
)
from repro_torch.runtime.straggler import StepTimeMonitor, StragglerConfig  # noqa: F401
from repro_torch.runtime.supervisor import (  # noqa: F401
    Supervisor,
    SupervisorConfig,
    Watchdog,
    WatchdogConfig,
)
