"""Runtime supervision: checkpoint/restart, straggler monitoring, step watchdog.

Counterpart of ``repro/runtime/supervisor.py``: any failure of a
synchronous step restores the latest *atomic* checkpoint and resumes.
``Supervisor.run`` wraps the step loop with:

* periodic async checkpoints (model + optimizer + data-iterator state);
* exception-triggered restore-and-resume with bounded restarts
  (``restarts`` counts them, so a run can show that none was hidden);
* straggler monitoring wired to a checkpoint-now callback.

:class:`Watchdog` is the serve-side counterpart: access-path faults
usually surface as order-of-magnitude *slowdowns* rather than errors, so
the serve loop deadlines every decode step against a budget derived from
:meth:`repro_torch.api.Runtime.decode_step_seconds` and escalates
consecutive breaches up a ladder — ``stall`` (log) → ``retry`` (recapture
the steps) → ``evacuate`` (migrate off the presumed-degraded far tier) →
``hang`` (raise, with full queue/slot diagnostics).  The ladder is pure
policy: it returns actions; the :class:`repro_torch.serve.scheduler.Server`
owns the side effects.

:meth:`Supervisor.rescale` reshards a training state onto a new mesh
(elastic restart): every leaf gathered whole from its shards, then the
new mesh's shard cut from it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import TYPE_CHECKING, Any, Callable

import torch

from repro_torch.models.sharding import gather_full, shard_of, tree_map
from repro_torch.runtime.straggler import StepTimeMonitor, StragglerConfig

if TYPE_CHECKING:  # checkpointer imports runtime.retry: keep the cycle lazy
    from repro_torch.checkpoint.checkpointer import Checkpointer

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Serve-step watchdog: deadline + escalation ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Deadline and escalation thresholds for the serve-step watchdog.

    The deadline is ``max(min_deadline_s, budget_factor * expected step
    seconds)`` — the expected time is the runtime's measured-else-analytic
    decode-step price, so the budget tightens as real measurements land.
    ``*_after`` are *consecutive* deadline breaches before each rung; a
    healthy step resets the count.
    """

    budget_factor: float = 8.0
    min_deadline_s: float = 0.25
    stall_after: int = 1
    retry_after: int = 2
    evacuate_after: int = 3
    hang_after: int = 4

    def validate(self) -> None:
        rungs = (self.stall_after, self.retry_after, self.evacuate_after,
                 self.hang_after)
        if any(r < 1 for r in rungs) or list(rungs) != sorted(rungs):
            raise ValueError(
                "watchdog escalation thresholds must be >= 1 and "
                f"non-decreasing (stall <= retry <= evacuate <= hang), "
                f"got {rungs}"
            )


class Watchdog:
    """Deadline serve steps; escalate stall → retry → evacuate → hang.

    ``expected_s`` is a zero-arg callable returning the current expected
    step seconds (the Server passes a closure over
    ``Runtime.decode_step_seconds`` so the budget follows calibration and
    replan migrations).  :meth:`observe` feeds one measured step and
    returns the action this breach count has escalated to; ``"ok"``
    resets the ladder.
    """

    ACTIONS = ("ok", "stall", "retry", "evacuate", "hang")

    def __init__(
        self,
        expected_s: Callable[[], float],
        cfg: WatchdogConfig = WatchdogConfig(),
    ):
        cfg.validate()
        self.expected_s = expected_s
        self.cfg = cfg
        self.breaches = 0
        self.last_step_s = 0.0
        self.actions = {a: 0 for a in self.ACTIONS}

    def deadline_s(self) -> float:
        """The current per-step budget."""
        return max(
            self.cfg.min_deadline_s,
            self.cfg.budget_factor * float(self.expected_s()),
        )

    def observe(self, seconds: float) -> str:
        """Feed one measured step; return the escalation action."""
        self.last_step_s = float(seconds)
        if self.last_step_s <= self.deadline_s():
            self.breaches = 0
            self.actions["ok"] += 1
            return "ok"
        self.breaches += 1
        cfg = self.cfg
        if self.breaches >= cfg.hang_after:
            action = "hang"
        elif self.breaches >= cfg.evacuate_after:
            action = "evacuate"
        elif self.breaches >= cfg.retry_after:
            action = "retry"
        else:
            action = "stall"
        self.actions[action] += 1
        log.warning(
            "watchdog: step took %.3gs > deadline %.3gs (breach %d) -> %s",
            self.last_step_s, self.deadline_s(), self.breaches, action,
        )
        return action


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

    # -- elastic -----------------------------------------------------------
    @staticmethod
    def rescale(state, specs, mesh, new_mesh, new_specs) -> Any:
        """Reshard ``state`` (this rank's shards under ``specs`` on
        ``mesh``) onto ``new_mesh`` under ``new_specs`` — the reference's
        device_put of the full state onto another mesh's shardings.  Each
        leaf is gathered whole over ``mesh`` (every rank of it takes part;
        None: the state is whole already), then the new mesh's shard of it
        is cut (``new_mesh`` None: the whole leaf) into storage of its own.
        Spec trees match the state by key.  A rank outside ``new_mesh``
        (onto fewer ranks) holds nothing afterwards and gets None."""
        full = state if mesh is None else tree_map(
            lambda x, sp: gather_full(x, sp, mesh), state, specs)
        if new_mesh is None:
            return full
        if new_mesh.get_coordinate() is None:
            return None
        return tree_map(lambda x, sp: shard_of(x, sp, new_mesh).clone(
            memory_format=torch.contiguous_format), full, new_specs)
