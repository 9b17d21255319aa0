"""Training step: loss and grads by autograd, then AdamW, on one device.

Counterpart of ``repro/train/train_step.py``.  ``TrainConfig.policy``
places the optimizer state: under ``hbm_resident`` (the default) params,
grads and the optimizer state all live in the device's memory; under
``opt_host`` (``master`` and ``opt_state`` at ``host:stream``) the f32
master and both moments live in pinned host memory and each step streams
them through the update window by window
(:func:`repro_torch.optim.adamw.apply_updates`), the reference's
``to_compute`` / ``to_storage``; under ``opt=host`` / ``master=host``
(RESIDENT) they live there too and the update reads and writes them in
place, on a card through its mapped view, over PCIe.  Params and grads
stay on the device.  The step is a plain function — PyTorch runs eagerly,
so there is no ``jit`` to wrap it in.

On a mesh (:mod:`repro_torch.launch.mesh`) whose ``pod`` axis has more
than one rank and whose other axes have one, the step is data parallel
over ``pod``: each rank trains on its own rows of the global batch (the
reference's ``"batch": ("pod", "data")``), and the gradients are
averaged over ``pod`` before the update, exactly in f32 by one
all-reduce, or with ``compress_pod_grads`` by
:func:`~repro_torch.optim.compression.compressed_grad_sync` alone (int8
on the wire, error feedback in ``ef``).  The metrics from the loss are
means over the pods.

What the port leaves out, each raising ``NotImplementedError`` when asked
for: sharding-rule overrides (``rules``), other FSDP axes or ZeRO stages
than the defaults, and a ``data`` or ``model`` axis of more than one rank
(ROADMAP A10); host placements of params, grads or activations in
training (the rest of ROADMAP A9c).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.api import Runtime
from repro_torch.core.placement import HostStream, PlacementPolicy, Role
from repro_torch.launch.mesh import axis_size, mesh_axes_dict
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim.adamw import (
    AdamWConfig,
    apply_updates,
    init_opt_state,
    master_windows,
    opt_windows,
)
from repro_torch.optim.compression import compressed_grad_sync, init_error_feedback

#: roles a training step can place in host memory (streamed or RESIDENT)
_HOST_ROLES = (Role.MASTER, Role.OPT_STATE)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"             # none | full | dots
    n_microbatches: int = 1
    compress_pod_grads: bool = False
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    rules: dict | None = None       # sharding-rule overrides (A10)
    fsdp_axes: tuple = ("data",)    # ZeRO axes (A10)
    zero_stage: int = 3
    #: placement of the train state: None = hbm_resident; any
    #: ``parse_policy`` spelling (``"opt_host"``, ``"opt=host:stream,..."``)
    policy: PlacementPolicy | str | None = None

    def check_ported(self, mesh=None) -> None:
        """Raise for the settings the port does not take: sharding rules,
        other FSDP axes or ZeRO stages, a mesh axis but ``pod`` with more
        than one rank (all ROADMAP A10)."""
        asked = []
        if self.rules:
            asked.append(f"rules={self.rules!r}")
        if tuple(self.fsdp_axes) != ("data",) or self.zero_stage != 3:
            asked.append(f"fsdp_axes={self.fsdp_axes!r}, zero_stage={self.zero_stage}")
        wide = {a: n for a, n in mesh_axes_dict(mesh).items() if a != "pod" and n > 1}
        if wide:
            asked.append(f"mesh axes {wide}")
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: sharding is not ported yet (ROADMAP A10); "
                "the port trains on one device or data parallel over a 'pod' axis"
            )
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {self.remat!r}")
        if self.n_microbatches < 1:
            raise ValueError(f"n_microbatches {self.n_microbatches}")

    def runtime(self, bundle, device) -> Runtime:
        """The :class:`~repro_torch.api.Runtime` of this config's policy
        on ``device``; raises for a placement the step cannot realize."""
        rt = Runtime(bundle, device, self.policy)
        for role in Role:
            if (role not in _HOST_ROLES and role is not Role.KV_CACHE
                    and rt.policy.placement(role).on_host):
                raise NotImplementedError(
                    f"policy {rt.policy.name!r} places {role.value} in host "
                    "memory: in training only the optimizer state (master, "
                    "opt_state) lives in host memory so far; params, grads "
                    "and activations there are the rest of ROADMAP A9c")
        return rt


def place_opt_state(rt: Runtime, opt_state: dict) -> dict:
    """``opt_state``'s master and moments where ``rt``'s policy puts them
    (rebound in place; a tree already there is kept as it is)."""
    opt_state["master"] = rt.realize(opt_state["master"], Role.MASTER)
    for k in ("mu", "nu"):
        opt_state[k] = rt.realize(opt_state[k], Role.OPT_STATE)
    return opt_state


def _host_streams(rt: Runtime, opt_state: dict) -> dict:
    """The HostStreams of the streamed optimizer roles over their windows."""
    out = {}
    if rt.streamed(Role.MASTER):
        out["master"] = HostStream(master_windows(opt_state), rt.device)
    if rt.streamed(Role.OPT_STATE):
        out["opt"] = HostStream(opt_windows(opt_state), rt.device)
    return out


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


def _pod_mean(tensors: list, group, n: int) -> list:
    """The f32 means over the ``pod`` group of ``tensors``: one all-reduce
    of their flat concatenation."""
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    return [part.reshape(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig, mesh=None):
    """Returns ``step(params, opt_state, ef, batch) -> (params, opt_state,
    ef, metrics)``.

    ``batch`` holds device tensors ``tokens`` and ``labels`` (B, S), and
    a frontend model's stub embeddings (``frame_embeds`` / ``patch_embeds``,
    B x ``frontend_tokens`` x d), which reach ``bundle.train_loss`` as
    they are.  On a ``pod`` mesh ``batch`` holds this rank's rows of the
    global batch, and the gradients and the loss's metrics are averaged
    over ``pod`` (exactly in f32, or with ``compress_pod_grads`` through
    the int8 sync, which updates ``ef``).  With
    ``n_microbatches = n`` the batch is split into n row blocks whose f32
    grads are summed and divided by n, and the loss is their mean; the
    other metrics are the last microbatch's, as in the reference.  Without
    a pod axis of several ranks ``ef`` passes through unchanged.
    ``opt_state``'s master and moments are updated in place; under a
    policy that places them in host memory they are realized there on the
    first step (and after a restore), and streamed through the update
    (``:stream``) or updated in place there (RESIDENT).
    """
    tcfg.check_ported(mesh)
    pods = axis_size(mesh, "pod")
    group = mesh.get_group("pod") if pods > 1 else None
    placed = {}      # the runtime and the streams over the current state

    def streams_for(params, opt_state):
        if "rt" not in placed:
            placed["rt"] = tcfg.runtime(bundle, tree_leaves(params)[0].device)
        rt = placed["rt"]
        if not any(rt.policy.placement(r).on_host for r in _HOST_ROLES):
            return None
        place_opt_state(rt, opt_state)      # again after a restore
        if not any(rt.streamed(r) for r in _HOST_ROLES):
            return None
        key = tuple(id(tree_leaves(opt_state[k])[0]) for k in ("master", "mu", "nu"))
        if placed.get("key") != key:
            placed["key"], placed["streams"] = key, _host_streams(rt, opt_state)
        return placed["streams"]

    def sync(loss, metrics, grads, ef):
        """The pod mean of the gradients and of the loss's metrics."""
        if tcfg.compress_pod_grads:
            grads, ef = compressed_grad_sync(grads, ef, mesh, "pod")
        elif pods > 1:
            it = iter(_pod_mean(tree_leaves(grads), group, pods))
            grads = tree_map(lambda g: next(it).to(g.dtype), grads)
        if pods > 1:
            keys = sorted(metrics)
            means = _pod_mean([torch.stack([loss.float()] + [metrics[k].float() for k in keys])],
                              group, pods)[0]
            loss, metrics = means[0], dict(zip(keys, means[1:]))
        return loss, metrics, grads, ef

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
        loss, metrics, grads, ef = sync(loss, metrics, grads, ef)
        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, opt_state, tcfg.optimizer,
            streams=streams_for(params, opt_state),
        )
        return new_params, new_opt, ef, {"loss": loss, **metrics, **opt_metrics}

    return step


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     tcfg: TrainConfig, mesh=None):
    """(params, opt_state, ef): weights drawn from ``generator`` on its
    device (the same on every rank of a mesh: seed each rank's generator
    alike), the f32 optimizer state placed under ``tcfg.policy`` (beside
    them, or in pinned host memory), and ``ef`` as the reference makes it:
    :func:`~repro_torch.optim.compression.init_error_feedback` with
    ``compress_pod_grads``, else one f32 zero per leaf."""
    tcfg.check_ported(mesh)
    rt = tcfg.runtime(bundle, generator.device)
    params = bundle.init_params(generator)
    opt_state = place_opt_state(rt, init_opt_state(params))
    if tcfg.compress_pod_grads:
        ef = init_error_feedback(params)
    else:
        ef = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                            device=p.device), params)
    return params, opt_state, ef
