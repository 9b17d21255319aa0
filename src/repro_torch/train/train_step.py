"""Training step: loss and grads by autograd, then AdamW, on one device.

Counterpart of ``repro/train/train_step.py``.  ``TrainConfig.policy``
places the params and the optimizer state, as the reference's
``rt.specs(Role.PARAMS)`` and its optimizer specs do.  Under
``hbm_resident`` (the default) params, grads and the optimizer state all
live in the device's memory.  Under ``opt_host`` (``master`` and
``opt_state`` at ``host:stream``) the f32 master and both moments live in
pinned host memory and each step streams them through the update window
by window (:func:`repro_torch.optim.adamw.apply_updates`), the
reference's ``to_compute`` / ``to_storage``; under ``opt=host`` /
``master=host`` (RESIDENT) they live there too and the update reads and
writes them in place, on a card through its mapped view, over PCIe.

The params in host memory: under ``params=host`` (RESIDENT) the step reads
them in place (on a card CUDA tensors over the mapped view of a pinned
arena) and the update writes the new params back into that arena in
place; under ``params=host:stream`` (``weights_stream``) the forward
stages each window of :meth:`~repro_torch.models.model_zoo.ModelBundle.
param_windows` through a :class:`~repro_torch.core.placement.HostStream`
of two device slots, the backward fetches them again, last first, and
the update casts each window's new params on the device and copies them
back into the host tree through the same slots.  Either way the loss and
its gradients come from :meth:`~repro_torch.models.model_zoo.ModelBundle.
train_loss_windowed`, which runs every layer as ``remat="full"`` (under
``none`` or ``dots`` a saved tensor could point into a staging slot the
next window overwrites: another ``remat`` is logged once and run as
``full``), and the grads land in a device tree.  With ``n_microbatches``
the windows stream once per microbatch.  Grads and activations stay on
the device: the reference's training step places neither.  An
encoder-decoder's training reads its params whole and raises under a
params placement in host memory (ROADMAP A7c).  The step is a plain
function — PyTorch runs eagerly, so there is no ``jit`` to wrap it in.

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
(ROADMAP A10); grads or activations in host memory, which the
reference's step does not place either (ROADMAP C, "Host roles in
training").
"""

from __future__ import annotations

import dataclasses
import logging

import torch
import torch.distributed as dist

from repro_torch.api import Runtime
from repro_torch.core.placement import HostStream, PlacementPolicy, Role
from repro_torch.core.warnings_registry import mark
from repro_torch.launch.mesh import axis_size, mesh_axes_dict
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.models.transformer import ParamViews, leaf_windows
from repro_torch.optim.adamw import (
    AdamWConfig,
    apply_updates,
    init_opt_state,
    master_windows,
    opt_windows,
)
from repro_torch.optim.compression import compressed_grad_sync, init_error_feedback

log = logging.getLogger("repro_torch.train")

#: roles a training step can place in host memory (streamed or RESIDENT)
_HOST_ROLES = (Role.PARAMS, Role.MASTER, Role.OPT_STATE)
#: the optimizer's roles, and the key of each in the optimizer state
_OPT_ROLES = {"master": Role.MASTER, "mu": Role.OPT_STATE, "nu": Role.OPT_STATE}


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
                    "memory: the reference's training step places only the "
                    "params and the optimizer state (master, opt_state), and "
                    "the port keeps grads and activations in device memory "
                    "(ROADMAP C, host roles in training)")
        if bundle.encdec and rt.policy.placement(Role.PARAMS).on_host:
            raise NotImplementedError(
                f"{bundle.cfg.name}: policy {rt.policy.name!r} places the params in "
                "host memory, and an encoder-decoder's training loops read them "
                "whole: not ported yet (ROADMAP A7c)")
        return rt


def place_opt_state(rt: Runtime, opt_state: dict) -> dict:
    """``opt_state``'s master and moments where ``rt``'s policy puts them
    (rebound in place; a tree already there is kept as it is)."""
    for k, role in _OPT_ROLES.items():
        opt_state[k] = rt.realize(opt_state[k], role)
    return opt_state


def _host_streams(bundle: ModelBundle, rt: Runtime, params, opt_state: dict) -> dict:
    """The HostStreams of the streamed roles over their windows: the
    optimizer's (``"master"``, ``"opt"``), and the params' forward and
    backward windows (``"source"``) and update windows (``"params"``,
    written back through the same slots)."""
    out = {}
    if rt.streamed(Role.PARAMS):
        out["source"] = HostStream(bundle.param_windows(params), rt.device)
        out["params"] = HostStream(leaf_windows(params), rt.device,
                                   slots=out["source"].buffers())
    if rt.streamed(Role.MASTER):
        out["master"] = HostStream(master_windows(opt_state), rt.device)
    if rt.streamed(Role.OPT_STATE):
        out["opt"] = HostStream(opt_windows(opt_state), rt.device)
    return out


def loss_and_grads(bundle: ModelBundle, params, batch: dict, remat: str):
    """(loss, metrics, grads) of one batch; grads in each param's dtype,
    in the params' tree structure.  For params in device memory: the step
    reads a tree in host memory window by window instead
    (:meth:`~repro_torch.models.model_zoo.ModelBundle.train_loss_windowed`),
    so that none of its leaves becomes a graph leaf."""
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
    (``:stream``) or updated in place there (RESIDENT).  Params in host
    memory are realized there too; the step reads them window by window
    (see the module's docstring) and writes the new params into them in
    place, and returns that same tree.  ``step.placed`` holds the
    runtime (``"rt"``) and the HostStreams over the current state
    (``"streams"``).
    """
    tcfg.check_ported(mesh)
    pods = axis_size(mesh, "pod")
    group = mesh.get_group("pod") if pods > 1 else None
    placed = {}      # the runtime and the streams over the current state

    def place(params, opt_state, device):
        """(runtime, params, streams): the state realized under the policy
        (again after a restore; a tree already there is kept) and the
        HostStreams over it (None when no role streams)."""
        if "rt" not in placed:
            placed["rt"] = rt = tcfg.runtime(bundle, device)
            if (rt.policy.placement(Role.PARAMS).on_host and tcfg.remat != "full"
                    and mark(f"train_remat:{bundle.cfg.name}:{rt.policy.name}")):
                log.warning("%s: params in host memory under %s: remat %r runs as "
                            "'full' (the step keeps no tensor of a params window)",
                            bundle.cfg.name, rt.policy.name, tcfg.remat)
        rt = placed["rt"]
        if not any(rt.policy.placement(r).on_host for r in _HOST_ROLES):
            return rt, params, None
        params = rt.realize(params, Role.PARAMS)
        place_opt_state(rt, opt_state)
        if not any(rt.streamed(r) for r in _HOST_ROLES):
            return rt, params, None
        key = tuple(id(tree_leaves(t)[0]) for t in
                    (params, opt_state["master"], opt_state["mu"], opt_state["nu"]))
        if placed.get("key") != key:
            placed["key"] = key
            placed["streams"] = _host_streams(bundle, rt, params, opt_state)
        return rt, params, placed["streams"]

    def grads_of(rt, params, streams, batch):
        """(loss, metrics, grads) of one (micro)batch; params in host memory
        are read window by window and their grads land in a device tree."""
        if not rt.policy.placement(Role.PARAMS).on_host:
            return loss_and_grads(bundle, params, batch, tcfg.remat)
        source = (streams["source"] if rt.streamed(Role.PARAMS)
                  else ParamViews(bundle.param_windows(params)))
        dev = batch["tokens"].device
        grads = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device=dev), params)
        loss, metrics = bundle.train_loss_windowed(source, batch, grads)
        return loss, metrics, grads

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
        dev = batch["tokens"].device
        rt, params, streams = place(params, opt_state, dev)
        n = tcfg.n_microbatches
        if n > 1:
            gsum = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=dev), params)
            losses = []
            for mb in range(n):
                part = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[mb]
                        for k, v in batch.items()}
                loss_mb, metrics, g = grads_of(rt, params, streams, part)
                tree_map(lambda a, b: a.add_(b), gsum, g)
                losses.append(loss_mb)
            grads = tree_map(lambda g: g / n, gsum)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, metrics, grads = grads_of(rt, params, streams, batch)
        loss, metrics, grads, ef = sync(loss, metrics, grads, ef)
        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, opt_state, tcfg.optimizer, streams=streams,
            in_place=rt.policy.placement(Role.PARAMS).on_host,
        )
        return new_params, new_opt, ef, {"loss": loss, **metrics, **opt_metrics}

    #: the runtime ("rt") and the HostStreams over the current state
    #: ("streams": "source", "params", "master", "opt") once a step ran
    step.placed = placed
    return step


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     tcfg: TrainConfig, mesh=None):
    """(params, opt_state, ef): weights drawn from ``generator`` on its
    device (the same on every rank of a mesh: seed each rank's generator
    alike), then placed under ``tcfg.policy`` (in device memory, or in
    pinned host memory), the f32 optimizer state drawn from them and
    placed role by role (so that at most one of its three trees is in
    device memory at a time), and ``ef`` as the reference makes it, on the
    generator's device: :func:`~repro_torch.optim.compression.
    init_error_feedback` with ``compress_pod_grads``, else one f32 zero
    per leaf."""
    tcfg.check_ported(mesh)
    rt = tcfg.runtime(bundle, generator.device)
    params = bundle.init_params(generator)
    opt_state = init_opt_state(params, place=lambda k, tree: rt.realize(tree, _OPT_ROLES[k]))
    if tcfg.compress_pod_grads:
        ef = init_error_feedback(params)
    else:
        ef = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                            device=p.device), params)
    return rt.realize(params, Role.PARAMS), opt_state, ef
