"""Straggler detection: step-time statistics + slow-step policy.

At thousand-node scale the synchronous step time is the max over workers
(the paper's own multi-worker timing rule, §III-B: total = max of final
timestamps).  A persistent straggler therefore sets the fleet's pace.  The
monitor keeps a rolling step-time distribution; a step exceeding
``threshold x median`` is flagged, and a configurable number of consecutive
flags triggers the mitigation callback (checkpoint-and-restart around the
slow host, the standard fleet response, wired up in supervisor.py).

A copy of ``repro/runtime/straggler.py``, which imports no JAX.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50             # steps in the rolling window
    threshold: float = 2.0       # flag if step > threshold * median
    patience: int = 3            # consecutive flags before mitigation
    warmup_steps: int = 5        # ignore compile/first steps


class StepTimeMonitor:
    def __init__(
        self,
        cfg: StragglerConfig = StragglerConfig(),
        on_straggler: Callable[[dict], None] | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.clock = clock
        self.times: deque[float] = deque(maxlen=cfg.window)
        self._start: float | None = None
        self._consecutive = 0
        self.flags: list[dict] = []
        self.steps = 0

    def __enter__(self):
        self._start = self.clock()
        return self

    def __exit__(self, *exc):
        self.record(self.clock() - self._start)
        return False

    def record(self, dt: float) -> bool:
        """Record one step; returns True if flagged as a straggler step.

        Flagged samples are kept OUT of the rolling window: appending them
        would inflate the median baseline, so a persistent straggler would
        stop exceeding ``threshold x median`` after a few flags and go
        undetected — the window holds only healthy steps, the flags list
        holds the stragglers, and ``summary()`` reports both.
        """
        self.steps += 1
        if self.steps <= self.cfg.warmup_steps:
            return False
        flagged = False
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.cfg.threshold * med:
                flagged = True
                self._consecutive += 1
                info = {
                    "step": self.steps,
                    "dt": dt,
                    "median": med,
                    "ratio": dt / med,
                    "consecutive": self._consecutive,
                }
                self.flags.append(info)
                if (
                    self._consecutive >= self.cfg.patience
                    and self.on_straggler is not None
                ):
                    self.on_straggler(info)
                    self._consecutive = 0
            else:
                self._consecutive = 0
        if not flagged:
            self.times.append(dt)
        return flagged

    def summary(self) -> dict:
        """Healthy-window stats + straggler count.  ``median_s``/``p99_s``
        describe the clean baseline (flagged steps excluded, consistent
        with ``record``); ``flags`` counts the excluded stragglers."""
        if not self.times:
            return {"steps": self.steps, "flags": len(self.flags)}
        ts = sorted(self.times)
        return {
            "steps": self.steps,
            "median_s": statistics.median(ts),
            "p99_s": ts[min(len(ts) - 1, int(0.99 * len(ts)))],
            "flags": len(self.flags),
        }
