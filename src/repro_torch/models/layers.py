"""Shared layers: norms, embeddings, RoPE, gated MLP, logits head.

Counterpart of ``repro/models/layers.py``.  Every layer is a
(param-defs function, apply fn) pair over plain dict pytrees; compute is in
the model dtype with float32 normalization statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def apply_head(params: dict, embed_params: dict, x: torch.Tensor):
    """Final logits in float32, accumulated in float32.

    A tied head reads ``embedding.T`` as a view.  On CUDA a 16-bit product
    goes through ``mm`` with ``out_dtype=float32``, so the (vocab, d)
    matrix is never upcast per step; the CPU has no such kernel and
    upcasts instead.
    """
    w = params["unembed"] if "unembed" in params else embed_params["embedding"].T
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32:
        logits = x2 @ w.float()
    elif x2.device.type == "cuda":
        logits = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        logits = x2.float() @ w.float()
    return logits.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding on split halves (not interleaved pairs).

    x: (..., S, D) with D even; positions: broadcastable to (..., S).  The
    frequencies are computed in float32, as the reference does: at yi's
    theta of 5e6 a float64 table would drift from it.
    """
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                      exponent)
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


_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def apply_mlp(params: dict, x: torch.Tensor, act: str = "silu"):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (_ACTS[act](g) * u) @ params["w_down"]
