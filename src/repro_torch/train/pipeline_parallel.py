"""GPipe pipeline parallelism over the ``pod`` axis.

Counterpart of ``repro/train/pipeline_parallel.py``.  For multi-pod meshes
the ``pod`` axis crosses DCN, the weakest link of the datapath model.
Pure DP on that axis all-reduces every gradient byte across it each step;
pipelining sends only microbatch activations across the cut.

Parameters are stacked over a leading stage dimension; rank ``r`` of the
axis applies ``stacked[r]`` (the reference's ``P(axis_name)`` split: every
rank passes the whole stack).  Microbatches advance through the stages in
``n_micro + n_stages - 1`` ticks with a cyclic point-to-point handoff to
rank + 1 (the reference's ``ppermute`` with ``fwd_perm``), and a final sum
over the axis gives every rank the last stage's outputs.

Differentiable.  The handoff's backward is the reverse permute, and the
final sum's backward is the identity: the output is replicated and every
rank computes the loss on its copy, so a summing backward would scale the
last stage's gradient by the number of ranks.  Each rank's gradient is
that of its own stage (the other slices of the stack get zeros), so the
gradients summed over ranks are the sequential model's.  Every rank builds
the same autograd graph (inputs are selected with ``torch.where``, never
by dropping a branch), so the handoffs' backward collectives run in the
same order on every rank; what stage 0 computes past the last microbatch
starts from zeros and reaches no output, so it adds exact zeros.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_size
from repro_torch.models.sharding import tree_leaves, tree_map


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to rank + ``shift`` and receive from rank - ``shift``
    (mod the group's size), both posted at once."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Handoff(torch.autograd.Function):
    """Cyclic handoff to the next stage; backward: the reverse permute."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _permute(y, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -1), None


class _SumReplicated(torch.autograd.Function):
    """Sum over the group; identity backward (the result is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable, group, n_stages: int, n_micro: int):
    """The per-rank pipelined apply: ``(params_local, x_micro) -> y``.

    ``params_local``: this stage's slice of the stacked params (leading
    dim 1); ``x_micro``: (n_micro, B, ...) microbatches.  ``stage_fn(p, x)
    -> x`` keeps the shape.  Returns the last stage's (n_micro, B, ...)
    outputs on every rank of ``group`` (``None``: one stage, no group).
    """

    def pick(cond, a, b):
        return torch.where(torch.tensor(cond, device=a.device), a, b)

    def apply(params_local, x_micro):
        p = tree_map(lambda t: t[0], params_local)
        stage = 0 if n_stages == 1 else dist.get_rank(group)
        n_ticks = n_micro + n_stages - 1
        zeros = torch.zeros_like(x_micro[0])
        first, last = stage == 0, stage == n_stages - 1
        buf, outs = zeros, []
        for t in range(n_ticks):
            # stage 0 takes in microbatch t while any remain, then zeros;
            # the others take the handoff (where keeps both in the graph)
            x_t = x_micro[min(t, n_micro - 1)]
            inject = pick(first, pick(t < n_micro, x_t, zeros), buf)
            y = stage_fn(p, inject)
            if t >= n_stages - 1:           # the last stage emits t - n_stages + 1
                outs.append(pick(last, y, torch.zeros_like(y)))
            if t < n_ticks - 1:             # the last tick's handoff reaches nothing
                buf = y if n_stages == 1 else _Handoff.apply(y, group)
        # only the last stage holds real outputs (the others zeros): one
        # sum over the group gives every rank them
        outs = torch.stack(outs)
        return outs if group is None else _SumReplicated.apply(outs, group)

    return apply


def pipelined_forward(mesh, stage_fn: Callable, stacked_params, x_micro,
                      axis_name: str = "pod"):
    """Run ``x_micro`` (n_micro, B, ...) through the stages of
    ``stacked_params`` (leading dim = the size of ``axis_name``) as a GPipe
    pipeline over that axis; every rank gets the outputs."""
    n_stages = axis_size(mesh, axis_name)
    rank = 0 if mesh is None else mesh.get_local_rank(axis_name)
    group = None if mesh is None else mesh.get_group(axis_name)
    lead = {t.shape[0] for t in tree_leaves(stacked_params)}
    if lead != {n_stages}:
        raise ValueError(f"stacked params lead with {sorted(lead)}, the {axis_name!r} "
                         f"axis has {n_stages} ranks")
    local = tree_map(lambda t: t[rank:rank + 1], stacked_params)
    return pipeline_apply(stage_fn, group, n_stages, x_micro.shape[0])(local, x_micro)

