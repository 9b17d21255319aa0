"""Training step: loss and grads by autograd, then AdamW, on one device.

Counterpart of ``repro/train/train_step.py`` under its default placement
(``hbm_resident``): params, grads and the optimizer state all live in the
device's memory.  The step is a plain function — PyTorch runs eagerly,
so there is no ``jit`` to wrap it in.

What the port leaves out until ROADMAP A9 (mesh, runtime and placement),
each raising ``NotImplementedError`` when asked for: sharding-rule
overrides (``rules``), other FSDP axes or ZeRO stages than the defaults,
and cross-pod gradient compression.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"             # none | full | dots
    n_microbatches: int = 1
    compress_pod_grads: bool = False
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    rules: dict | None = None       # sharding-rule overrides (needs a mesh)
    fsdp_axes: tuple = ("data",)    # ZeRO axes (needs a mesh)
    zero_stage: int = 3

    def check_ported(self) -> None:
        """Raise for the settings that need a mesh or compression."""
        asked = []
        if self.rules:
            asked.append(f"rules={self.rules!r}")
        if tuple(self.fsdp_axes) != ("data",) or self.zero_stage != 3:
            asked.append(f"fsdp_axes={self.fsdp_axes!r}, zero_stage={self.zero_stage}")
        if self.compress_pod_grads:
            asked.append("compress_pod_grads=True")
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: sharding and gradient compression are "
                "not ported yet (ROADMAP A9); the port trains on one device"
            )
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {self.remat!r}")
        if self.n_microbatches < 1:
            raise ValueError(f"n_microbatches {self.n_microbatches}")


def loss_and_grads(bundle: ModelBundle, params, batch: dict, remat: str):
    """(loss, metrics, grads) of one batch; grads in each param's dtype,
    in the params' tree structure."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, metrics = bundle.train_loss(live, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig):
    """Returns ``step(params, opt_state, ef, batch) -> (params, opt_state,
    ef, metrics)``.

    ``batch`` holds device tensors ``tokens`` and ``labels`` (B, S).  With
    ``n_microbatches = n`` the batch is split into n row blocks whose f32
    grads are summed and divided by n, and the loss is their mean; the
    other metrics are the last microbatch's, as in the reference.  ``ef``
    (the compression error feedback) passes through unchanged.
    ``opt_state``'s master and moments are updated in place.
    """
    tcfg.check_ported()

    def step(params, opt_state, ef, batch):
        n = tcfg.n_microbatches
        if n > 1:
            gsum = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            losses = []
            for mb in range(n):
                part = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[mb]
                        for k, v in batch.items()}
                loss_mb, metrics, g = loss_and_grads(bundle, params, part,
                                                     tcfg.remat)
                tree_map(lambda a, b: a.add_(b), gsum, g)
                losses.append(loss_mb)
            grads = tree_map(lambda g: g / n, gsum)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, metrics, grads = loss_and_grads(bundle, params, batch,
                                                  tcfg.remat)
        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, opt_state, tcfg.optimizer
        )
        return new_params, new_opt, ef, {"loss": loss, **metrics, **opt_metrics}

    return step


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     tcfg: TrainConfig):
    """(params, opt_state, ef): weights drawn from ``generator`` on its
    device, the f32 optimizer state beside them, and ``ef`` as the
    reference makes it without compression (one f32 zero per leaf)."""
    tcfg.check_ported()
    params = bundle.init_params(generator)
    opt_state = init_opt_state(params)
    ef = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                        device=p.device), params)
    return params, opt_state, ef
