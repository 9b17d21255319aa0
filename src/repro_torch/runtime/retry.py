"""Shared retry policy: capped exponential backoff + deterministic jitter.

A copy of ``repro/runtime/retry.py`` (it imports no JAX; the port keeps
its own copy).  In the port it prices checkpoint writes
(:class:`repro_torch.checkpoint.checkpointer.Checkpointer`); in the
reference it also prices live migrations and evacuations.  The knobs are
the standard ones (attempt cap, base/max delay, jitter fraction, total
time budget), but two choices are deliberate:

* **Deterministic jitter.**  The jitter draw is seeded from
  ``(seed, attempt)``, never from global randomness — a faulted run
  replays exactly, which the chaos soak and the bit-identity tests
  depend on.
* **Caller-declared retryability.**  ``retry_on`` has no default broad
  enough to catch real bugs: callers name the transient types
  (injected link faults in the reference, ``OSError`` for checkpoint
  I/O).  A deterministic error — a missing donor axis in the reference —
  would just burn the budget, so such call sites exclude it.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, TypeVar

log = logging.getLogger("repro_torch.runtime.retry")

T = TypeVar("T")

__all__ = [
    "RetryPolicy",
    "RetryBudgetExceeded",
    "retry_call",
    "DEFAULT_RETRY",
    "MIGRATION_RETRY",
    "CHECKPOINT_RETRY",
]


class RetryBudgetExceeded(RuntimeError):
    """Every attempt failed (or the time budget ran out); carries the
    last underlying error as ``__cause__`` and ``.last``."""

    def __init__(self, label: str, attempts: int, last: BaseException):
        self.label = label
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"{label or 'operation'} failed after {attempts} attempt(s): "
            f"{last!r}"
        )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with seeded jitter and a time budget.

    Delay for attempt ``n`` (0-indexed) is
    ``min(base_delay_s * 2**n, max_delay_s)`` scaled by a deterministic
    jitter in ``[1 - jitter, 1 + jitter]``.  ``budget_s`` bounds the
    *total* time spent sleeping between attempts — a per-operation
    budget, so a retried migration cannot stall the serve loop longer
    than the watchdog's evacuation deadline.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.1
    budget_s: float | None = None

    def delay_s(self, attempt: int, seed: int = 0) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        if self.jitter > 0.0:
            # one int key per (seed, attempt): tuple seeding is hash-based
            # (deprecated, and not stable across processes)
            u = random.Random(int(seed) * 1_000_003 + attempt).random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(d, 0.0)

    def scaled(self, **overrides) -> "RetryPolicy":
        return dataclasses.replace(self, **overrides)


#: the repo-wide default: 3 attempts, 50ms doubling to 2s, 10% jitter.
DEFAULT_RETRY = RetryPolicy()

#: serve-path migrations get a tighter budget: backoff must stay well
#: under the watchdog's step deadline or the retry *is* the stall.
MIGRATION_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=0.01, max_delay_s=0.25, budget_s=2.0
)

#: checkpoint writes are off the hot path and may wait out a slow disk.
CHECKPOINT_RETRY = RetryPolicy(
    max_attempts=4, base_delay_s=0.1, max_delay_s=5.0, budget_s=30.0
)


def retry_call(
    fn: Callable[[], T],
    *,
    retry_on: tuple[type[BaseException], ...],
    policy: RetryPolicy = DEFAULT_RETRY,
    label: str = "",
    seed: int = 0,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` under ``policy``, retrying only ``retry_on`` errors.

    ``on_retry(attempt, error, delay_s)`` fires before each backoff
    sleep (counters, logging).  Exhaustion raises
    :class:`RetryBudgetExceeded` chaining the last error; any exception
    outside ``retry_on`` propagates immediately (deterministic failures
    must not burn the budget).
    """
    if policy.max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {policy}")
    slept = 0.0
    attempts = 0
    last: BaseException | None = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as e:
            last = e
            attempts = attempt + 1
            if attempts >= policy.max_attempts:
                break
            d = policy.delay_s(attempt, seed)
            if policy.budget_s is not None and slept + d > policy.budget_s:
                log.warning(
                    "%s: retry budget %.3gs exhausted after %d attempt(s)",
                    label or "retry", policy.budget_s, attempts,
                )
                break
            if on_retry is not None:
                on_retry(attempt, e, d)
            log.info(
                "%s: attempt %d/%d failed (%r); retrying in %.3gs",
                label or "retry", attempts, policy.max_attempts, e, d,
            )
            sleep(d)
            slept += d
    assert last is not None
    raise RetryBudgetExceeded(label, attempts, last) from last
