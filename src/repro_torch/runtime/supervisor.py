"""Runtime supervision: checkpoint/restart and straggler monitoring.

Counterpart of ``Supervisor`` in ``repro/runtime/supervisor.py``: any
failure of a synchronous step restores the latest *atomic* checkpoint and
resumes.  ``Supervisor.run`` wraps the step loop with:

* periodic async checkpoints (model + optimizer + data-iterator state);
* exception-triggered restore-and-resume with bounded restarts
  (``restarts`` counts them, so a run can show that none was hidden);
* straggler monitoring wired to a checkpoint-now callback.

Left out until their prerequisites are ported: the serve-step
``Watchdog`` (ROADMAP A11) and ``rescale`` onto a new mesh (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.runtime.straggler import StepTimeMonitor, StragglerConfig

if TYPE_CHECKING:  # checkpointer imports runtime.retry: keep the cycle lazy
    from repro_torch.checkpoint.checkpointer import Checkpointer

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_every: int = 50
    max_restarts: int = 3
    straggler: StragglerConfig = dataclasses.field(default_factory=StragglerConfig)


class Supervisor:
    def __init__(
        self,
        ckpt: Checkpointer,
        cfg: SupervisorConfig = SupervisorConfig(),
    ):
        self.ckpt = ckpt
        self.cfg = cfg
        self.restarts = 0
        self._ckpt_requested = False
        self.monitor = StepTimeMonitor(
            cfg.straggler, on_straggler=self._on_straggler
        )

    def _on_straggler(self, info: dict) -> None:
        log.warning("straggler detected: %s — requesting checkpoint", info)
        self._ckpt_requested = True

    def run(
        self,
        state: Any,                         # pytree (params, opt, ef, ...)
        step_fn: Callable[[Any, dict], tuple[Any, dict]],
        data_iter,
        n_steps: int,
        start_step: int = 0,
        extra_state: Callable[[], dict] | None = None,
    ) -> tuple[Any, int]:
        """Run ``n_steps`` with checkpoint/restart. Returns (state, step)."""
        step = start_step
        while step < n_steps:
            try:
                batch = next(data_iter)
                with self.monitor:
                    state, metrics = step_fn(state, batch)
                step += 1
                if (
                    step % self.cfg.checkpoint_every == 0
                    or self._ckpt_requested
                ):
                    self._ckpt_requested = False
                    self.ckpt.save(
                        step,
                        state,
                        extra=(extra_state() if extra_state else {})
                        | {"step": step},
                    )
            except StopIteration:
                break
            except Exception as e:  # node failure / preemption surrogate
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from e
                log.warning("step failed (%s); restoring from checkpoint", e)
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                state, manifest = self.ckpt.restore(state)
                step = manifest["extra"].get("step", latest)
                if hasattr(data_iter, "restore") and "data" in manifest["extra"]:
                    data_iter.restore(manifest["extra"]["data"])
        self.ckpt.wait()
        return state, step
