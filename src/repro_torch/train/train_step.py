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

On a mesh (:mod:`repro_torch.launch.mesh`) over ``pod``, ``data`` and
``model`` the state is sharded by the reference's logical-axis rules
(:func:`make_state_specs`, through :meth:`~repro_torch.api.Runtime.specs`):
each rank holds its shard of every leaf.  Each rank trains on the rows
``_batch_spec``'s ``("pod", "data")`` gives it (:func:`batch_shard`;
ranks along an axis the spec drops see the same rows).
- ``model`` (Megatron tensor parallelism, the dense decoder's GQA
  attention, MLP, embedding and head: ``models/layers.py``,
  ``models/attention.py``): every rank computes the same loss on its
  heads, ``d_ff`` columns and vocab rows, and each leaf's gradient comes
  out of the backward whole for the rank's shard (a replicated leaf a
  rank uses in part is summed over ``model`` inside the backward).
- ``data`` under ``zero_stage >= 3`` (ZeRO-3, ``fsdp_axes=("data",)``):
  params, master and moments are sharded over ``data`` too; the loss runs
  window by window (every layer as ``remat="full"``; another ``remat`` is
  logged once) over :class:`~repro_torch.models.transformer.
  GatheredWindows`, which gathers each window's params before the forward
  and again in the backward, last first, and reduce-scatters its
  gradients into the rank's shard.  Under ``zero_stage < 3`` (ZeRO-1)
  the params are whole over ``data``, the gradients are reduce-scattered
  into the optimizer's shards after the backward, the update runs on the
  rank's shard, and the new params are all-gathered over ``data``.  A
  leaf no dim of which ``data`` divides stays whole: its gradient is
  all-reduced.  Every reduction sums in f32 and divides by the ranks.
- ``pod``: the gradients are averaged over ``pod`` before the update,
  exactly in f32 by one all-reduce, or with ``compress_pod_grads`` by
  :func:`~repro_torch.optim.compression.compressed_grad_sync` alone (int8
  on the wire, error feedback in ``ef``).
Only ``data``/``model`` axes of several ranks are sharded over
(:func:`sharded_axes`); over one rank the reference's XLA makes FSDP and
tensor parallelism no-ops, so a (2, 1, 1) mesh trains as a ``pod`` mesh
does (any placement and ``remat``).  ``make_train_step(...,
one_rank=True)`` runs the collectives and the windows over one-rank axes
anyway, to measure their cost on one card.
The metrics from the loss are means over ``data`` and ``pod``, and
``grad_norm`` is exact: each leaf's squared sum is reduced over the axes
it is sharded on (:func:`~repro_torch.optim.adamw.global_norm`).

What the port leaves out, each raising ``NotImplementedError`` when asked
for: donor axes (ROADMAP A10c); a ``model`` axis over MoE, SSM, MLA or
the encoder-decoder/VLM, rules that put another logical axis on a mesh
axis of several ranks, other FSDP axes than ``data``, and params in host
memory on a step sharded over ``data``/``model`` (ROADMAP A10b, rest); an
encoder-decoder under ZeRO-3 with ``data > 1`` (ROADMAP A7c); grads or
activations in host memory, which the reference's step does not place
either (ROADMAP C, "Host roles in training").
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
from repro_torch.models.sharding import (
    P,
    all_gather_leaves,
    batch_block,
    reduce_scatter_leaves,
    unrealized_rules,
    shard_dim,
    shard_of,
    spec_axes,
    tree_leaves,
    tree_map,
    use_sharding,
)
from repro_torch.models.transformer import GatheredWindows, ParamViews, leaf_windows
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


#: mesh axes the training step realizes
_AXES = ("pod", "data", "model")


def sharded_axes(mesh, one_rank: bool = False) -> set:
    """The ``data``/``model`` axes a step shards over: those of several
    ranks (over one rank the reference's XLA makes FSDP and tensor
    parallelism no-ops, and so does the port), or with ``one_rank`` every
    one the mesh has."""
    return {a for a, n in mesh_axes_dict(mesh).items()
            if a in ("data", "model") and (n > 1 or one_rank)}


def _refuse_params_on_host(rt: Runtime, axes: set) -> None:
    """Raise for params in host memory on a step that shards over ``axes``."""
    if axes and rt.policy.placement(Role.PARAMS).on_host:
        raise NotImplementedError(
            f"policy {rt.policy.name!r} places the params in host memory on a step "
            f"sharded over {sorted(axes)}: sharded params in host memory are not "
            "ported yet (ROADMAP A10b, rest)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"             # none | full | dots
    n_microbatches: int = 1
    compress_pod_grads: bool = False
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    rules: dict | None = None       # sharding-rule overrides (an overlay)
    fsdp_axes: tuple = ("data",)    # ZeRO axes for optimizer state (+ params)
    zero_stage: int = 3             # 3: shard params+opt; 1: opt only
    #: placement of the train state: None = hbm_resident; any
    #: ``parse_policy`` spelling (``"opt_host"``, ``"opt=host:stream,..."``)
    policy: PlacementPolicy | str | None = None

    def check_ported(self, mesh=None, bundle: ModelBundle | None = None) -> None:
        """Raise for what the port does not train: a donor axis (ROADMAP
        A10c); rules that split a logical axis over a mesh axis of several
        ranks the layers do not realize it on, FSDP axes but ``data``, a
        ``model`` axis of several ranks over a family without tensor-parallel
        layers (``bundle``; all ROADMAP A10b, rest); an encoder-decoder
        under ZeRO-3 over several ``data`` ranks (ROADMAP A7c)."""
        axes = mesh_axes_dict(mesh)
        donor = {a: n for a, n in axes.items() if a not in _AXES}
        if donor:
            raise NotImplementedError(
                f"mesh axes {donor}: donor axes (the peer and remote placements) "
                "are not ported yet (ROADMAP A10c)")
        odd = unrealized_rules(self.rules, mesh)
        if odd or tuple(self.fsdp_axes) not in ((), ("data",)):
            raise NotImplementedError(
                f"rules {odd or ''} fsdp_axes={tuple(self.fsdp_axes)!r} over mesh axes "
                f"{axes}: the port's layers split heads, kv_heads, d_ff and vocab over "
                "'model', the batch over 'pod'/'data', and FSDP over 'data' only "
                "(ROADMAP A10b, rest)")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage {self.zero_stage}")
        if bundle is not None:
            bundle.check_model_axis(axes.get("model", 1))
            if bundle.encdec and self.zero_stage >= 3 and axes.get("data", 1) > 1:
                raise NotImplementedError(
                    f"{bundle.cfg.name}: ZeRO-3 over {axes['data']} data ranks gathers "
                    "the params window by window, and an encoder-decoder's training "
                    "loops read them whole: not ported yet (ROADMAP A7c); "
                    "zero_stage=1 trains it")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {self.remat!r}")
        if self.n_microbatches < 1:
            raise ValueError(f"n_microbatches {self.n_microbatches}")

    def runtime(self, bundle, device, mesh=None) -> Runtime:
        """The :class:`~repro_torch.api.Runtime` of this config's policy
        on ``device`` (and ``mesh``, with ``rules``); raises for a
        placement the step cannot realize."""
        rt = Runtime(bundle, device, self.policy, mesh=mesh, rules=self.rules)
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
        _refuse_params_on_host(rt, sharded_axes(mesh))
        return rt


def make_state_specs(bundle: ModelBundle, mesh, policy=None, rules: dict | None = None,
                     fsdp_axes: tuple = ("data",), zero_stage: int = 3):
    """PartitionSpecs of (params, opt_state) under the placement policy:
    the params over ``fsdp_axes`` too under ZeRO-3, the master and moments
    always.  Realized through :meth:`repro_torch.api.Runtime.specs`, so a
    peer/remote placement would land on the mesh's donor axis (and raises
    ``DonorAxisError`` without one); (None, None) without a mesh."""
    rt = Runtime(bundle, "meta", policy, mesh=mesh, rules=rules)
    defs = bundle.param_defs()
    param_specs = rt.specs(Role.PARAMS, defs,
                           fsdp_axes=fsdp_axes if zero_stage >= 3 else ())
    if param_specs is None:
        return None, None
    member = rt.specs(Role.OPT_STATE, defs, fsdp_axes=fsdp_axes)
    return param_specs, {"master": member, "mu": member, "nu": member, "step": P()}


def batch_shard(global_batch: int, mesh, rules: dict | None = None) -> tuple[int, int]:
    """(index, count): this rank's block of the global batch's rows under
    the reference's ``_batch_spec`` (``"batch": ("pod", "data")``, with its
    divisibility drop), as ``SyntheticLM``'s ``process_index`` and
    ``process_count`` take them; (0, 1) without a mesh.  Ranks along an
    axis the spec leaves out see the same rows."""
    return batch_block(global_batch, mesh, rules)


class _Dim:
    """A stacked leaf's ``data`` dim, as :func:`~repro_torch.models.
    transformer.param_windows` slices it: ``[i]`` is the dim of the
    leaf's layer slice."""

    def __init__(self, dim: int | None):
        self.dim = dim

    def __getitem__(self, i):
        if self.dim == 0:
            raise NotImplementedError(
                "a stacked leaf sharded over 'data' on its layer dim (no other "
                "dim divides the axis): its windows are not gathered yet "
                "(ROADMAP A10b, rest)")
        return None if self.dim is None else self.dim - 1


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


class _MeshPlan:
    """What a step on a mesh realizes: the specs of the params and of the
    optimizer state, per leaf the ``data`` dim of each, whether ZeRO-3
    gathers windows, and the axes the gradients' norm reduces over."""

    def __init__(self, bundle: ModelBundle, tcfg: TrainConfig, mesh, sharded: set):
        self.mesh, self.axes, self.sharded = mesh, mesh_axes_dict(mesh), sharded
        self.pspecs, ospecs = make_state_specs(bundle, mesh, tcfg.policy, tcfg.rules,
                                               tcfg.fsdp_axes, tcfg.zero_stage)
        self.ospecs = ospecs["master"]
        self.data = self.axes.get("data", 1)
        #: per leaf: the data dim of its gradient's reduction (the
        #: optimizer's), that of the ZeRO-1 all-gather of the new params,
        #: and the axes of several ranks it is sharded over
        self.grad_dims = tree_map(lambda o: shard_dim(o, "data"), self.ospecs)
        self.gather_dims = tree_map(
            lambda p, o: None if shard_dim(p, "data") is not None else shard_dim(o, "data"),
            self.pspecs, self.ospecs)
        self.norm_axes = tree_map(
            lambda o: tuple(a for a in sorted(spec_axes(o)) if self.axes[a] > 1), self.ospecs)
        self.windowed = (tcfg.zero_stage >= 3 and "data" in sharded
                         and "data" in tcfg.fsdp_axes and not bundle.encdec)
        if self.windowed:
            dims = tree_map(lambda sp: shard_dim(sp, "data"), self.pspecs)
            dims["stages"] = [tree_map(_Dim, st) for st in dims["stages"]]
            self.window_dims = bundle.param_windows(dims)

    @staticmethod
    def _aligned(tree, per_leaf) -> list:
        """``per_leaf``'s values in ``tree``'s leaf order (dict entries
        match by key)."""
        return tree_leaves(tree_map(lambda _, v: v, tree, per_leaf))

    def reduce(self, grads):
        """The f32 sums over ``data`` of each rank's gradients, each leaf as
        the optimizer shards it."""
        it = iter(reduce_scatter_leaves(tree_leaves(grads), self._aligned(grads, self.grad_dims),
                                        self.mesh, "data"))
        return tree_map(lambda _: next(it), grads)

    def shards(self, params):
        """``params`` (whole over ``data`` under ZeRO-1) sliced as the
        optimizer shards them (views)."""
        rank = self.mesh.get_local_rank("data") if "data" in self.axes else 0

        def one(p, d):
            if d is None:
                return p
            n = p.shape[d] // self.data
            return p.narrow(d, rank * n, n)

        return tree_map(one, params, self.gather_dims)

    def gather(self, params):
        """The new params whole over ``data`` again (ZeRO-1)."""
        dims = self._aligned(params, self.gather_dims)
        if "data" not in self.sharded or all(d is None for d in dims):
            return params
        it = iter(all_gather_leaves(tree_leaves(params), dims, self.mesh, "data"))
        return tree_map(lambda _: next(it).contiguous(), params)


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig, mesh=None, *,
                    one_rank: bool = False):
    """Returns ``step(params, opt_state, ef, batch) -> (params, opt_state,
    ef, metrics)``.

    ``batch`` holds device tensors ``tokens`` and ``labels`` (B, S), and
    a frontend model's stub embeddings (``frame_embeds`` / ``patch_embeds``,
    B x ``frontend_tokens`` x d), which reach ``bundle.train_loss`` as
    they are.  On a mesh ``batch`` holds this rank's rows
    (:func:`batch_shard`) and ``params``/``opt_state`` its shards
    (:func:`init_train_state`); the gradients are reduced over ``data``
    and averaged over ``pod`` (exactly in f32, or with
    ``compress_pod_grads`` through the int8 sync, which updates ``ef``),
    and the loss's metrics are means over both (see the module's
    docstring).  With ``n_microbatches = n`` the batch is split into n row
    blocks whose f32 grads are summed and divided by n, and the loss is
    their mean; the other metrics are the last microbatch's, as in the
    reference.  Without a pod axis of several ranks ``ef`` passes through
    unchanged.  ``opt_state``'s master and moments are updated in place;
    under a policy that places them in host memory they are realized
    there on the first step (and after a restore), and streamed through
    the update (``:stream``) or updated in place there (RESIDENT).
    Params in host memory are realized there too; the step reads them
    window by window (see the module's docstring) and writes the new
    params into them in place, and returns that same tree.
    ``step.placed`` holds the runtime (``"rt"``), the HostStreams over the
    current state (``"streams"``) and a ZeRO-3 step's last
    :class:`~repro_torch.models.transformer.GatheredWindows`
    (``"source"``).

    Only ``data``/``model`` axes of several ranks are sharded over
    (:func:`sharded_axes`): a (2, 1, 1) mesh trains as a ``pod`` mesh does.
    ``one_rank`` runs the collectives and ZeRO-3's window gathers over
    the mesh's one-rank ``data``/``model`` axes too, which measures their
    cost on one card (they compute the identity there).
    """
    tcfg.check_ported(mesh, bundle)
    pods = axis_size(mesh, "pod")
    group = mesh.get_group("pod") if pods > 1 else None
    sharded = sharded_axes(mesh, one_rank)
    plan = _MeshPlan(bundle, tcfg, mesh, sharded) if sharded else None
    if (plan is not None and plan.windowed and tcfg.remat != "full"
            and mark(f"train_remat_zero3:{bundle.cfg.name}")):
        log.warning("%s: ZeRO-3 gathers the params window by window: remat %r runs as "
                    "'full' (the step keeps no tensor of a gathered window)",
                    bundle.cfg.name, tcfg.remat)
    placed = {}      # the runtime and the streams over the current state

    def place(params, opt_state, device):
        """(runtime, params, streams): the state realized under the policy
        (again after a restore; a tree already there is kept) and the
        HostStreams over it (None when no role streams)."""
        if "rt" not in placed:
            placed["rt"] = rt = tcfg.runtime(bundle, device, mesh)
            _refuse_params_on_host(rt, sharded)
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
        are read window by window and their grads land in a device tree.
        On a ``data``/``model`` mesh the grads come back summed over
        ``data`` (in f32), as the optimizer shards them: ZeRO-3's windows
        write the sums into a tree of the params' dtype, as one device's
        backward accumulates a leaf that several windows read."""
        if plan is not None and plan.windowed:
            source = GatheredWindows(bundle.param_windows(params), plan.window_dims, mesh)
            placed["source"] = source
            dev = batch["tokens"].device
            grads = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device=dev),
                             params)
            loss, metrics = bundle.train_loss_windowed(source, batch, grads)
            return loss, metrics, grads
        if not rt.policy.placement(Role.PARAMS).on_host:
            loss, metrics, grads = loss_and_grads(bundle, params, batch, tcfg.remat)
        else:
            source = (streams["source"] if rt.streamed(Role.PARAMS)
                      else ParamViews(bundle.param_windows(params)))
            dev = batch["tokens"].device
            grads = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device=dev),
                             params)
            loss, metrics = bundle.train_loss_windowed(source, batch, grads)
        if plan is not None and "data" in plan.sharded:
            grads = plan.reduce(grads)
        return loss, metrics, grads

    def sync(loss, metrics, grads, ef):
        """The means over ``data`` and ``pod`` of the gradients and of the
        loss's metrics."""
        if plan is not None and plan.data > 1:
            tree_map(lambda g: g.div_(plan.data), grads)
            loss, metrics = _metric_mean(loss, metrics, mesh.get_group("data"), plan.data)
        if tcfg.compress_pod_grads:
            grads, ef = compressed_grad_sync(grads, ef, mesh, "pod")
        elif pods > 1:
            it = iter(_pod_mean(tree_leaves(grads), group, pods))
            grads = tree_map(lambda g: next(it).to(g.dtype), grads)
        if pods > 1:
            loss, metrics = _metric_mean(loss, metrics, group, pods)
        return loss, metrics, grads, ef

    def step(params, opt_state, ef, batch):
        with use_sharding(mesh, tcfg.rules):
            return run(params, opt_state, ef, batch)

    def run(params, opt_state, ef, batch):
        dev = batch["tokens"].device
        rt, params, streams = place(params, opt_state, dev)
        n = tcfg.n_microbatches
        if n > 1:
            gsum, losses = None, []
            for mb in range(n):
                part = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[mb]
                        for k, v in batch.items()}
                loss_mb, metrics, g = grads_of(rt, params, streams, part)
                if gsum is None:
                    gsum = tree_map(lambda x: x.to(torch.float32, copy=True), g)
                else:
                    tree_map(lambda a, b: a.add_(b), gsum, g)
                losses.append(loss_mb)
            grads = tree_map(lambda g: g / n, gsum)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, metrics, grads = grads_of(rt, params, streams, batch)
        loss, metrics, grads, ef = sync(loss, metrics, grads, ef)
        on_host = rt.policy.placement(Role.PARAMS).on_host
        if plan is None:
            new_params, new_opt, opt_metrics = apply_updates(
                params, grads, opt_state, tcfg.optimizer, streams=streams,
                in_place=on_host)
        else:
            new_params, new_opt, opt_metrics = apply_updates(
                plan.shards(params), grads, opt_state, tcfg.optimizer, streams=streams,
                norm_axes=plan.norm_axes, mesh=mesh)
            new_params = plan.gather(new_params)
        return new_params, new_opt, ef, {"loss": loss, **metrics, **opt_metrics}

    #: the runtime ("rt"), the HostStreams over the current state
    #: ("streams": "source", "params", "master", "opt") once a step ran,
    #: and a ZeRO-3 step's GatheredWindows ("source")
    step.placed = placed
    return step


def _metric_mean(loss, metrics, group, n):
    """The means over ``group`` of the loss and the loss's metrics."""
    keys = sorted(metrics)
    means = _pod_mean([torch.stack([loss.float()] + [metrics[k].float() for k in keys])],
                      group, n)[0]
    return means[0], dict(zip(keys, means[1:]))


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     tcfg: TrainConfig, mesh=None):
    """(params, opt_state, ef): weights drawn from ``generator`` on its
    device (the same on every rank of a mesh: seed each rank's generator
    alike; the full weights are drawn, so the values are one device's),
    then placed as :func:`place_train_state` places them."""
    tcfg.check_ported(mesh, bundle)
    return place_train_state(bundle, bundle.init_params(generator), tcfg, mesh)


def place_train_state(bundle: ModelBundle, params, tcfg: TrainConfig, mesh=None):
    """(params, opt_state, ef) from the full weights ``params``: on a
    ``data``/``model`` mesh this rank's shards (:func:`make_state_specs`)
    of the params and of the master and moments; the params placed under
    ``tcfg.policy`` (in device memory, or in pinned host memory), the f32
    optimizer state made from them and placed role by role (so that at
    most one of its three trees is in device memory at a time), and
    ``ef`` as the reference makes it, on the params' device:
    :func:`~repro_torch.optim.compression.init_error_feedback` (shaped as
    the optimizer's shards) with ``compress_pod_grads``, else one f32
    zero per leaf."""
    tcfg.check_ported(mesh, bundle)
    dev = tree_leaves(params)[0].device
    rt = tcfg.runtime(bundle, dev, mesh)
    master = params
    if sharded_axes(mesh):
        pspecs, ospecs = make_state_specs(bundle, mesh, tcfg.policy, tcfg.rules,
                                          tcfg.fsdp_axes, tcfg.zero_stage)
        master = tree_map(lambda p, sp: shard_of(p, sp, mesh), params, ospecs["master"])
        params = tree_map(lambda p, sp: shard_of(p, sp, mesh).clone(), params, pspecs)
    opt_state = init_opt_state(master, place=lambda k, tree: rt.realize(tree, _OPT_ROLES[k]))
    del master
    if tcfg.compress_pod_grads:
        ef = init_error_feedback(tree_map(
            lambda m: torch.empty(m.shape, device=dev), opt_state["mu"]))
    else:
        ef = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                            device=p.device), params)
    return rt.realize(params, Role.PARAMS), opt_state, ef
