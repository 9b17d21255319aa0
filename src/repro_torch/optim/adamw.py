"""AdamW with an f32 master copy, on the device that holds the params.

Counterpart of ``repro/optim/adamw.py``.  Mixed precision as in the
reference: live params in the model dtype, an f32 master copy and two f32
moments — 12 bytes of optimizer state per parameter against 2 of bf16
weights.  Under ``hbm_resident`` that state lives in device memory.  Under
``opt_host`` (``master`` and ``opt_state`` at ``host:stream``) it lives in
pinned host memory and :func:`apply_updates` streams it through the
update window by window (``streams``): each window is staged on the device
(the reference's ``to_compute``), updated there, and copied back (its
``to_storage``), while params and grads stay on the device.  The update
is elementwise, so a window's values are bit for bit those of the whole
tensor's update.  Under ``opt=host`` / ``master=host`` (RESIDENT) the
state lives in pinned host memory too, and the unstreamed path updates
it in place there (on a card the leaves are CUDA tensors over the card's
mapped view of it: every pass of the update crosses PCIe).

The master and the moments are updated **in place** (the port's
counterpart of the reference's donated state buffers: no second 12-byte
copy per parameter at the peak); the params come back as new tensors
cast from the master, or, for params in host memory (``in_place``), are
cast into their own storage: in place under ``params=host`` (RESIDENT),
and under ``params=host:stream`` window by window into a device slot
that is copied back into the host tree (``streams["params"]``), in the
same walk over the windows as a streamed master and moments.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.models.transformer import leaf_windows


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params, place=None) -> dict:
    """The f32 master (a copy of ``params``), both moments at zero and the
    step count, on the params' device.  ``place(key, tree)`` (``key`` of
    "master", "mu", "nu") moves each tree where it lives as soon as it is
    made, so that only one of them is on the device at a time."""
    dev = tree_leaves(params)[0].device
    place = place or (lambda key, tree: tree)
    out = {"master": place("master", tree_map(
        lambda x: x.detach().to(torch.float32, copy=True), params))}
    for k in ("mu", "nu"):
        out[k] = place(k, tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params))
    out["step"] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32, memory_format=torch.contiguous_format)))


def global_norm(tree, axes=None, mesh=None) -> torch.Tensor:
    """The f32 L2 norm over every leaf.  Each leaf is summed in its logical
    order (a contiguous f32 copy), so equal values give the same norm
    whatever their memory layout: a tied embedding's gradient comes out of
    autograd as its head product's transpose, and a gradient written into
    a fresh tree does not.

    On a mesh, ``axes`` (a tree like ``tree``) names per leaf the mesh
    axes it is sharded over: the squared sums of the leaves sharded over
    the same axes are added and all-reduced over those axes, and a leaf
    every rank holds whole counts once, so the norm is the whole tree's."""
    if axes is None:
        return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))
    groups: dict[tuple, list] = {}
    tree_map(lambda x, ax: groups.setdefault(tuple(ax), []).append(_square_sum(x)),
             tree, axes)
    total = None
    for ax in sorted(groups):
        part = sum(groups[ax])
        for a in ax:
            dist.all_reduce(part, group=mesh.get_group(a))
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig, *, streams=None,
                  in_place: bool = False, norm_axes=None, mesh=None):
    """One AdamW step -> (new params, state, {"grad_norm", "lr"}).

    On a mesh every tree holds this rank's shards (the params as the
    optimizer shards them) and ``norm_axes`` the axes each leaf is sharded
    over, for the exact :func:`global_norm`.

    ``state``'s master and moments are updated in place; its ``step`` is
    replaced.  Every scalar stays a device tensor: no host sync.
    ``streams`` (``{"master", "opt", "params"}``: HostStreams over
    :func:`master_windows`, :func:`opt_windows` and ``leaf_windows`` of a
    streamed params tree, each optional) streams a host-resident role
    through the update window by window; None updates every role in place.
    ``in_place``: the new params are cast into ``params``' own storage
    (params in host memory), which comes back as the new params.
    """
    step = state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads, norm_axes, mesh)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def update(w, g, m, v):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        w.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                     + cfg.weight_decay * w))

    if not streams:
        tree_map(update, state["master"], grads, state["mu"], state["nu"])
        if in_place:
            tree_map(lambda p, w: p.copy_(w), params, state["master"])
            new_params = params
        else:
            new_params = tree_map(lambda p, w: w.to(p.dtype, copy=True), params,
                                  state["master"])
    else:
        new_params = _streamed_update(update, params, grads, state, streams, in_place)
    state["step"] = step
    return new_params, state, {"grad_norm": gnorm, "lr": lr}


def master_windows(state: dict) -> list[dict]:
    """The windows in which a streamed update reads the master: each
    top-level param entry, then each layer (``leaf_windows``)."""
    return leaf_windows(state["master"])


def opt_windows(state: dict) -> list[dict]:
    """The moments' windows, ``{"mu", "nu"}`` of the same leaves as
    :func:`master_windows`."""
    return [{"mu": m, "nu": v} for m, v in
            zip(leaf_windows(state["mu"]), leaf_windows(state["nu"]))]


def _streamed_update(update, params, grads, state, streams, in_place):
    """``update`` window by window, each host-resident role staged on the
    device and written back after; the new params cast from each window's
    master into place (a streamed params window into its staging slot,
    then copied back into the host tree)."""
    new_params = params if in_place else tree_map(torch.empty_like, params)
    out_w, grad_w = leaf_windows(new_params), leaf_windows(grads)
    master_w, opt_w = master_windows(state), opt_windows(state)
    live = [st for st in (streams.get(k) for k in ("master", "opt", "params"))
            if st is not None]
    for st in live:
        st.begin()
    for i in range(len(out_w)):
        w = master_w[i] if streams.get("master") is None else streams["master"].window(i)
        mv = opt_w[i] if streams.get("opt") is None else streams["opt"].window(i)
        tree_map(update, w, grad_w[i], mv["mu"], mv["nu"])
        out = out_w[i] if streams.get("params") is None else streams["params"].stage(i)
        tree_map(lambda dst, src: dst.copy_(src), out, w)
        for st in live:
            st.write_back(i)
    for st in live:
        st.finish()
    return new_params
