"""Mixture-of-Experts: GShard-style grouped dispatch on one device.

Counterpart of ``repro/models/moe.py``.  Routing turns each token group
into dense one-hot ``dispatch`` / ``combine`` tensors of (token, expert,
capacity slot); batched products against them gather each expert's rows,
run every expert's gated FFN on its capacity buffer and scatter the
outputs back.  On a mesh the reference's dispatch is an all-to-all over
the expert axis; here every expert lives on the one device, so the
dispatch is a product in its memory and every expert's weights are read
once per call, whatever the routing.

Every shape is static — the group size, the capacity and the buffers
follow from the input's shape alone, with no host read of a routing
decision — so a serving step that routes captures in a CUDA graph.
Capacity overflow drops tokens in (token, choice) order (standard
GShard); the aux load-balancing loss comes back beside the output.
"""

from __future__ import annotations

import torch

from repro_torch.configs import MoESpec
from repro_torch.models.layers import ACTS, apply_mlp, mlp_defs
from repro_torch.models.sharding import Param


def moe_defs(d: int, spec: MoESpec) -> dict:
    ff = spec.d_ff_expert
    defs = {
        "router": Param((d, spec.n_experts), ("embed", None)),
        "w_gate": Param((spec.n_experts, d, ff), ("experts", "embed", "d_ff")),
        "w_up": Param((spec.n_experts, d, ff), ("experts", "embed", "d_ff")),
        "w_down": Param((spec.n_experts, ff, d), ("experts", "d_ff", "embed")),
    }
    if spec.n_shared:
        defs["shared"] = mlp_defs(d, spec.n_shared * ff)
    return defs


#: tokens per dispatch group: the dispatch tensors' bytes grow as tokens x
#: group, so smaller groups move less (at some routing-drop cost)
DEFAULT_GROUP = 2048


def capacity(group: int, spec: MoESpec) -> int:
    """Rows of each expert's buffer for a group: ``group · top_k /
    n_experts · capacity_factor``, at least ``max(top_k, 4)``, rounded up
    to a multiple of 4."""
    c = int(group * spec.top_k / spec.n_experts * spec.capacity_factor)
    c = max(spec.top_k, c, 4)
    return (c + 3) // 4 * 4


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last dim,
    largest first, ties to the lower index as ``jax.lax.top_k`` breaks
    them (``torch.topk`` leaves their order unspecified)."""
    if k == 1:
        idx = torch.argmax(probs, dim=-1, keepdim=True)   # the first maximum
        return torch.gather(probs, -1, idx), idx
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(params: dict, x: torch.Tensor, spec: MoESpec, act: str = "silu",
              group_size: int = DEFAULT_GROUP):
    """x: (B, S, d) -> (out (B, S, d), aux loss (f32 scalar)).

    The ``B · S`` tokens are cut into groups of ``min(group_size, B · S)``
    in row-major order, so in serving a row's output depends on the rows
    it is routed with (through the capacity).  The expert products are
    batched over the experts with the stacked weights as they lie (no
    permuted copy of a weight); the dispatch and combine tensors are
    contracted over the top-k choices as they are built, so no (token,
    choice, expert, slot) tensor exists.
    """
    B, S, d = x.shape
    E, K = spec.n_experts, spec.top_k
    T = B * S
    G = min(group_size, T)
    n_groups = T // G
    assert T % G == 0, (T, G)
    C = capacity(G, spec)

    xg = x.reshape(n_groups, G, d)
    logits = (xg @ params["router"]).float()                  # (g, G, E)
    probs = torch.softmax(logits, dim=-1)

    gate_vals, gate_idx = top_k(probs, K)                     # (g, G, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) in its expert's capacity buffer,
    # counted over the flattened (token, choice) order
    experts = torch.arange(E, device=x.device)
    onehot = (gate_idx[..., None] == experts).float()         # (g, G, K, E)
    pos = torch.cumsum(onehot.reshape(n_groups, G * K, E), dim=1)
    pos = pos.reshape(n_groups, G, K, E) * onehot - 1.0
    in_cap = (pos < C) & (pos >= 0)

    pos_sk = torch.where(in_cap, pos, 0.0).sum(3)             # (g, G, K)
    slots = torch.arange(C, device=x.device)
    onehot_c = (pos_sk.long()[..., None] == slots).float()    # (g, G, K, C)
    keep_e = onehot * in_cap.float()                          # (g, G, K, E)
    dispatch = torch.einsum("gske,gskc->gsec", keep_e, onehot_c)
    combine = torch.einsum("gske,gskc->gsec", keep_e * gate_vals[..., None], onehot_c)

    # each expert's buffer: (E, g·C, d), experts as the batch dim
    xin = torch.bmm(dispatch.to(x.dtype).reshape(n_groups, G, E * C).transpose(1, 2), xg)
    xin = xin.reshape(n_groups, E, C, d).transpose(0, 1).reshape(E, n_groups * C, d)
    g_ = torch.bmm(xin, params["w_gate"])
    u = torch.bmm(xin, params["w_up"])
    eout = torch.bmm(ACTS[act](g_) * u, params["w_down"])     # (E, g·C, d)
    eout = eout.reshape(E, n_groups, C, d).transpose(0, 1).reshape(n_groups, E * C, d)

    out = torch.bmm(combine.to(x.dtype).reshape(n_groups, G, E * C), eout)
    out = out.reshape(B, S, d)
    if spec.n_shared:
        out = out + apply_mlp(params["shared"], x, act)

    # GShard load-balancing aux loss
    me = probs.mean(dim=(0, 1))                               # (E,)
    ce = onehot.sum(2).mean(dim=(0, 1))                       # fraction routed
    aux = E * torch.sum(me * ce)
    return out, aux
