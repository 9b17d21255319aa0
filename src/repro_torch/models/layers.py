"""Shared layers: norms, embeddings, RoPE, gated MLP, logits head.

Counterpart of ``repro/models/layers.py``.  Every layer is a
(param-defs function, apply fn) pair over plain dict pytrees; compute is in
the model dtype with float32 normalization statistics.

Tensor parallelism (Megatron) over the ``model`` axis of the mesh that
:func:`~repro_torch.models.sharding.use_sharding` installed, where the
reference's ``shard`` constraints let XLA insert the collectives: a layer
whose rules split its weights over ``model`` (:func:`model_split`) runs on
its rank's shard between Megatron's two operators, :class:`CopyToModel`
(identity forward, all-reduce backward) and the all-reduce forward of
:class:`ReduceFromModel` / :func:`row_parallel` (identity backward).
Every rank computes the same residual stream and the same loss, so a leaf
that a rank uses whole and in full (a norm's scale) gets its whole
gradient there, and a replicated leaf a rank uses only in part (a query
norm over its heads) goes through :class:`CopyToModel` too.  The sums run
in float32: 16-bit partials are added as a one-device product accumulates
them.  ``apply_mlp`` (column-parallel ``w_gate``/``w_up``, row-parallel
``w_down``), ``apply_embed`` (a vocab-parallel lookup) and
``fused_cross_entropy`` (logits split on vocab, the max, the sum of
exponentials and the gold logit reduced over ``model``) take the global
width of their split dim (``d_ff=``, ``vocab=``); without it, or without
a mesh, they run whole, as on one device.  Serving (forward only) takes
``apply_head(vocab=)``: each rank's logits of its vocab rows are gathered
over ``model`` (:func:`gather_vocab`), so the sampler sees whole rows, as
the reference's XLA gathers them for its sampler.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.sharding import (
    COLLECTIVES,
    P,
    Param,
    current_mesh,
    gather_dim,
    mesh_shape,
    one_rank_axes,
    spec_for,
)


# ---------------------------------------------------------------------------
# Tensor parallelism over the mesh's ``model`` axis
# ---------------------------------------------------------------------------

def model_split(name: str, dim: int | None):
    """(group, ranks, rank) of the current mesh's ``model`` axis when the
    rules split a ``dim``-wide logical axis ``name`` over it; None when
    that dim stays whole (no mesh, a one-rank axis unless the context
    splits over one rank too, ``dim`` None, or the divisibility drop)."""
    mesh = current_mesh()
    if mesh is None or dim is None:
        return None
    if mesh_shape(mesh).get("model", 1) < 2 and not one_rank_axes():
        return None
    if spec_for((dim,), (name,), mesh) != P("model"):
        return None
    return (mesh.get_group("model"), mesh_shape(mesh)["model"],
            mesh.get_local_rank("model"))


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, added in float32, in x's dtype."""
    y = x.float() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(y, group=group)
    COLLECTIVES["all_reduce"] += 1
    return y.to(x.dtype)


class CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward; the backward sums the gradient
    over the model group (each rank's part of a replicated input's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the sum over the model group forward; identity
    backward (every rank holds the whole gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RowParallel(torch.autograd.Function):
    """``x2 @ w`` with ``w``'s rows split over the model group: each rank's
    partial product in float32, summed over the group, cast to x2's dtype;
    the backward is the product's (identity for the sum)."""

    @staticmethod
    def forward(ctx, x2, w, group):
        ctx.save_for_backward(x2, w)
        y = head_product(x2, w)
        dist.all_reduce(y, group=group)
        COLLECTIVES["all_reduce"] += 1
        return y.to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.T, x2.T @ g, None


def row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """(..., k) x (k, n) -> (..., n) over a row-split ``w`` (see
    :class:`_RowParallel`)."""
    lead = x.shape[:-1]
    return _RowParallel.apply(x.reshape(-1, x.shape[-1]), w, group).reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_defs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": Param((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        return {
            "scale": Param((d,), ("embed",), init="ones"),
            "bias": Param((d,), ("embed",), init="zeros"),
        }
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def apply_norm(params: dict, x: torch.Tensor, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(x.dtype)
    # layernorm / olmo's non-parametric layernorm.  jnp.var is the
    # population variance: torch's default would be the unbiased one.
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding + logits
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d: int) -> dict:
    return {"embedding": Param((vocab, d), ("vocab", "embed"), scale=0.02)}


def apply_embed(params: dict, tokens: torch.Tensor, *, scale: bool = False,
                vocab: int | None = None):
    """The rows of ``tokens``; with ``vocab`` split over ``model`` a rank
    looks up the rows it holds, zeros the others, and the sum over the
    group completes every row (exactly: one term is not zero)."""
    e = params["embedding"]
    tp = model_split("vocab", vocab)
    if tp is None:
        out = e[tokens.long()]
    else:
        n = e.shape[0]
        ids = tokens.long() - tp[2] * n
        hit = (ids >= 0) & (ids < n)
        out = ReduceFromModel.apply(e[ids.clamp(0, n - 1)] * hit[..., None].to(e.dtype),
                                    tp[0])
    if scale:
        out = out * torch.tensor(e.shape[1] ** 0.5, dtype=out.dtype)
    return out


def head_defs(vocab: int, d: int, tied: bool) -> dict:
    if tied:
        return {}
    return {"unembed": Param((d, vocab), ("embed", "vocab"))}


class _HeadProduct(torch.autograd.Function):
    """``x @ w`` of 16-bit operands on the card with float32 logits.

    The forward is ``mm`` with ``out_dtype=float32`` (f32 accumulation, no
    upcast of the (d, vocab) matrix); the backward feeds the f32 cotangent
    to 16-bit products as a TPU's default-precision dot does.
    """

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.T, x2.T @ g


def head_product(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, d) x (d, V) -> (N, V) float32 logits, accumulated in float32.

    float32 operands multiply as they are; 16-bit ones go through
    :class:`_HeadProduct` on the card and are upcast on the CPU, which has
    no mixed-precision ``mm``.  Differentiable on every route.
    """
    if x2.dtype == torch.float32:
        return x2 @ w.float()
    if x2.device.type == "cuda":
        return _HeadProduct.apply(x2, w)
    return x2.float() @ w.float()


def _head_weight(params: dict, embed_params: dict) -> torch.Tensor:
    return params["unembed"] if "unembed" in params else embed_params["embedding"].T


def gather_vocab(logits: torch.Tensor, tp) -> torch.Tensor:
    """(N, V/m) logits of a rank's vocab rows -> the whole (N, V) rows,
    gathered over the ``model`` group ``tp`` (forward only: serving's
    sampler)."""
    group, m, _ = tp
    return gather_dim(logits, 1, group, m)


def apply_head(params: dict, embed_params: dict, x: torch.Tensor, *,
               vocab: int | None = None):
    """Final logits in float32, accumulated in float32.

    A tied head reads ``embedding.T`` as a view; see :func:`head_product`.
    With ``vocab`` split over ``model`` each rank computes the logits of
    its vocab rows and they are gathered (:func:`gather_vocab`): every
    rank returns whole rows.
    """
    w = _head_weight(params, embed_params)
    lead = x.shape[:-1]
    logits = head_product(x.reshape(-1, x.shape[-1]), w)
    tp = model_split("vocab", vocab)
    if tp is not None:
        logits = gather_vocab(logits, tp)
    return logits.reshape(*lead, logits.shape[-1])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits (B,S,V) f32, labels (B,S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def fused_cross_entropy(
    params: dict,
    embed_params: dict,
    x: torch.Tensor,          # (B, S, d) final hidden states
    labels: torch.Tensor,     # (B, S)
    block: int = 512,
    *,
    vocab: int | None = None,
) -> torch.Tensor:
    """Head projection fused into a seq-chunked CE.

    Never materializes the full (B, S, V) f32 logits: one (B, block, V)
    slab lives at a time and is recomputed in the backward
    (``checkpoint``).  The projection keeps the head in the model dtype
    with f32 accumulation (:func:`head_product`).  With ``vocab`` split
    over ``model`` a rank's slab holds its vocab columns only: their max
    (a stabilizer, no gradient), sum of exponentials and gold logit are
    reduced over the group, so no rank ever holds a full row of logits.
    """
    w = _head_weight(params, embed_params)
    B, S, d = x.shape
    blk = min(block, S)
    if S % blk:
        blk = S
    tp = model_split("vocab", vocab)
    if tp is not None:
        x = CopyToModel.apply(x, tp[0])

    def one(xs, ls):
        logits = head_product(xs.reshape(-1, d), w)
        if tp is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, ls.reshape(-1, 1).long())[:, 0]
            return torch.sum(logz - gold)
        group, _, rank = tp
        n = logits.shape[1]
        mx = logits.detach().amax(dim=-1, keepdim=True)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        logz = mx[:, 0] + torch.log(ReduceFromModel.apply(
            torch.sum(torch.exp(logits - mx), dim=-1), group))
        ids = ls.reshape(-1, 1).long() - rank * n
        hit = (ids[:, 0] >= 0) & (ids[:, 0] < n)
        gold = ReduceFromModel.apply(
            torch.gather(logits, -1, ids.clamp(0, n - 1))[:, 0] * hit, group)
        return torch.sum(logz - gold)

    total = sum(
        checkpoint(one, x[:, i:i + blk], labels[:, i:i + blk],
                   use_reentrant=False)
        for i in range(0, S, blk)
    )
    return total / (B * S)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding on split halves (not interleaved pairs).

    x: (..., S, D) with D even; positions: broadcastable to (..., S).  The
    frequencies are computed in float32, as the reference does: at yi's
    theta of 5e6 a float64 table would drift from it.  The base is filled
    on the device, not copied from the host, so a CUDA graph can capture
    the serving steps that call this.
    """
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full_like(exponent, theta), exponent)
    angles = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (GLU family)
# ---------------------------------------------------------------------------

def mlp_defs(d: int, ff: int) -> dict:
    return {
        "w_gate": Param((d, ff), ("embed", "d_ff")),
        "w_up": Param((d, ff), ("embed", "d_ff")),
        "w_down": Param((ff, d), ("d_ff", "embed")),
    }


ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def apply_mlp(params: dict, x: torch.Tensor, act: str = "silu", *,
              d_ff: int | None = None):
    """The gated MLP; with ``d_ff`` split over ``model``, column-parallel
    ``w_gate``/``w_up`` and row-parallel ``w_down``."""
    tp = model_split("d_ff", d_ff)
    if tp is not None:
        x = CopyToModel.apply(x, tp[0])
        h = ACTS[act](x @ params["w_gate"]) * (x @ params["w_up"])
        return row_parallel(h, params["w_down"], tp[0])
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (ACTS[act](g) * u) @ params["w_down"]
