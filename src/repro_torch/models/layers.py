"""Shared layers: norms, embeddings, RoPE, gated MLP, logits head.

Counterpart of ``repro/models/layers.py``.  Every layer is a
(param-defs function, apply fn) pair over plain dict pytrees; compute is in
the model dtype with float32 normalization statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.sharding import Param


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


def apply_embed(params: dict, tokens: torch.Tensor, *, scale: bool = False):
    e = params["embedding"]
    out = e[tokens.long()]
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


def apply_head(params: dict, embed_params: dict, x: torch.Tensor):
    """Final logits in float32, accumulated in float32.

    A tied head reads ``embedding.T`` as a view; see :func:`head_product`.
    """
    w = _head_weight(params, embed_params)
    lead = x.shape[:-1]
    logits = head_product(x.reshape(-1, x.shape[-1]), w)
    return logits.reshape(*lead, w.shape[-1])


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
) -> torch.Tensor:
    """Head projection fused into a seq-chunked CE.

    Never materializes the full (B, S, V) f32 logits: one (B, block, V)
    slab lives at a time and is recomputed in the backward
    (``checkpoint``).  The projection keeps the head in the model dtype
    with f32 accumulation (:func:`head_product`).
    """
    w = _head_weight(params, embed_params)
    B, S, d = x.shape
    blk = min(block, S)
    if S % blk:
        blk = S

    def one(xs, ls):
        logits = head_product(xs.reshape(-1, d), w)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls.reshape(-1, 1).long())[:, 0]
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


def apply_mlp(params: dict, x: torch.Tensor, act: str = "silu"):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (ACTS[act](g) * u) @ params["w_down"]
