"""Mamba-2 block (SSD) with its prefill and decode paths.

Counterpart of ``repro/models/ssm.py`` (``ssm_defs``, ``ssm_cache_defs``,
``ssm_train``, ``ssm_prefill``, ``ssm_prefill_at``, ``ssm_decode``).
Training and prefill run the chunked SSD scan
(:func:`repro_torch.kernels.ops.ssd_scan`: on the card the CUDA kernel,
carrying the recurrent state in prefill, with its backward kernel in
training); decode is the O(1) recurrence against the
(conv, ssm) state cache — the SSM's answer to the KV cache, whose bytes
are constant in sequence length.

As with the KV cache, the (conv, ssm) state is updated **in place**: a
layer receives views of its slice of the stacked cache and writes through
them; the scan writes its final state straight into the ``ssm`` view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import SSMSpec
from repro_torch.kernels import ops
from repro_torch.models.sharding import Param

SSD_CHUNK = 256


def ssm_defs(d_model: int, spec: SSMSpec) -> dict:
    di = spec.d_inner(d_model)
    h = spec.n_heads(d_model)
    n = spec.d_state
    conv_dim = di + 2 * n
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": Param((d_model, 2 * di + 2 * n + h), ("embed", "d_inner")),
        "conv_w": Param((spec.d_conv, conv_dim), (None, "d_inner")),
        "conv_b": Param((conv_dim,), ("d_inner",), init="zeros"),
        "a_log": Param((h,), ("ssm_heads",), init="zeros"),
        "dt_bias": Param((h,), ("ssm_heads",), init="zeros"),
        "d_skip": Param((h,), ("ssm_heads",), init="ones"),
        "norm_scale": Param((di,), ("d_inner",), init="ones"),
        "w_out": Param((di, d_model), ("d_inner", "embed")),
    }


def ssm_cache_defs(batch: int, d_model: int, spec: SSMSpec) -> dict:
    di = spec.d_inner(d_model)
    h = spec.n_heads(d_model)
    n = spec.d_state
    return {
        "conv": Param(
            (batch, spec.d_conv - 1, di + 2 * n),
            ("batch", None, "d_inner"), init="zeros",
        ),
        "ssm": Param(
            (batch, h, spec.head_dim, n),
            ("batch", "ssm_heads", None, "state"), init="zeros",
            dtype="float32",   # recurrent state accumulates in f32
        ),
    }


def _split(proj, di, n, h):
    z = proj[..., :di]
    xs = proj[..., di : 2 * di]
    b = proj[..., 2 * di : 2 * di + n]
    c = proj[..., 2 * di + n : 2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n :]
    return z, xs, b, c, dt


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    yz = y * F.silu(z.float()).to(y.dtype)
    yf = yz.float()
    out = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + eps)
    return (out * scale.float()).to(y.dtype)


def _causal_conv(full, params, S: int, d_conv: int, dtype):
    """Depthwise causal conv over ``full`` (B, d_conv-1+S, conv_dim), the
    window's history first; SiLU in float32, back to ``dtype``."""
    kern = params["conv_w"]
    conv = sum(full[:, i : i + S] * kern[i][None, None, :]
               for i in range(d_conv)) + params["conv_b"]
    return F.silu(conv.float()).to(dtype)


def _scan_inputs(params, conv, dt, di, n):
    """x, B, C as views of the conv output; dt and A in float32."""
    xs, bmat, cmat = conv[..., :di], conv[..., di : di + n], conv[..., di + n :]
    dtf = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["a_log"].float())
    return xs, bmat, cmat, dtf, A


def _finish(params, y, xh, z, di):
    """Skip term, gated RMS norm and the output projection."""
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xh
    B, S = y.shape[:2]
    y = _gated_rmsnorm(y.reshape(B, S, di), z, params["norm_scale"])
    return y @ params["w_out"]


def _chunk(S: int) -> int:
    """The oracle's chunk: SSD_CHUNK, or S when S is not a multiple (the
    kernel walks its own chunks whatever this is)."""
    chunk = min(SSD_CHUNK, S)
    return S if S % chunk else chunk


def ssm_train(params, x, d_model: int, spec: SSMSpec):
    """x (B, S, d) -> (B, S, d), from zero state, differentiable: the scan
    goes through its autograd Function (the backward kernel on the card)."""
    B, S, _ = x.shape
    di, h, n, p = spec.d_inner(d_model), spec.n_heads(d_model), spec.d_state, spec.head_dim

    proj = x @ params["w_in"]
    z, xs, bmat, cmat, dt = _split(proj, di, n, h)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    full = F.pad(xbc, (0, 0, spec.d_conv - 1, 0))
    conv = _causal_conv(full, params, S, spec.d_conv, x.dtype)
    xs, bmat, cmat, dtf, A = _scan_inputs(params, conv, dt, di, n)
    xh = xs.reshape(B, S, h, p)
    y = ops.ssd_scan(xh, dtf, A, bmat, cmat, chunk=_chunk(S))
    return _finish(params, y, xh, z, di)


def ssm_prefill(params, x, cache, d_model: int, spec: SSMSpec):
    """Whole-prompt pass from zero state; fills ``cache`` (in place) with
    the final (conv, ssm) state.  x (B, S, d) -> (B, S, d).

    The reference takes ``chunk = min(256, S)`` and its oracle asserts
    ``S % chunk == 0``; here an S off the multiple takes chunk S (same
    result up to rounding) instead of failing."""
    B, S, _ = x.shape
    di, h, n, p = spec.d_inner(d_model), spec.n_heads(d_model), spec.d_state, spec.head_dim

    proj = x @ params["w_in"]
    z, xs, bmat, cmat, dt = _split(proj, di, n, h)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    conv_state = xbc[:, -(spec.d_conv - 1):]          # pre-activation window
    full = F.pad(xbc, (0, 0, spec.d_conv - 1, 0))
    conv = _causal_conv(full, params, S, spec.d_conv, x.dtype)
    xs, bmat, cmat, dtf, A = _scan_inputs(params, conv, dt, di, n)
    xh = xs.reshape(B, S, h, p)
    y, _ = ops.ssd_scan(xh, dtf, A, bmat, cmat, chunk=_chunk(S),
                        return_state=True, state_out=cache["ssm"])
    cache["conv"].copy_(conv_state)
    return _finish(params, y, xh, z, di)


def ssm_prefill_at(
    params, x, cache, offsets, new_lens, d_model: int, spec: SSMSpec
):
    """Chunk prefill continuing from the cached (conv, ssm) state.

    Row ``b`` consumes ``new_lens[b] <= S`` tokens; positions past
    ``new_lens`` get ``dt = 0`` (decay ``exp(0) = 1``, zero input add), so
    the recurrent state after the scan equals the state after exactly
    ``new_lens`` real steps — rows with ``new_lens == 0`` keep both state
    tensors bit for bit.  The causal conv window is seeded from the cached
    pre-activation tail, and the new conv state is the last ``d_conv - 1``
    *valid* entries of the [cached ++ chunk] stream, gathered per row.

    A row whose ``offsets == 0`` starts from ZERO state, whatever the cache
    holds: the recurrent state is cumulative (unlike a KV slot it cannot be
    overwritten by position), and a freed slot's state keeps integrating
    the full-batch decode steps it idles through.  Those rows are zeroed in
    the cache before the scan, which then reads and writes the ``ssm``
    view in place.  Returns the block output.
    """
    B, S, _ = x.shape
    di, h, n, p = spec.d_inner(d_model), spec.n_heads(d_model), spec.d_state, spec.head_dim
    new_lens = new_lens.to(torch.int32)
    fresh = offsets.to(torch.int32) == 0                       # (B,)
    conv_cache, ssm_cache = cache["conv"], cache["ssm"]
    conv_cache.masked_fill_(fresh[:, None, None], 0)
    ssm_cache.masked_fill_(fresh[:, None, None, None], 0)

    proj = x @ params["w_in"]
    z, xs, bmat, cmat, dt = _split(proj, di, n, h)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    full = torch.cat([conv_cache.to(xbc.dtype), xbc], dim=1)  # (B, d_conv-1+S, conv_dim)
    idx = new_lens.long()[:, None] + torch.arange(spec.d_conv - 1, device=x.device)[None, :]
    conv_state = torch.gather(full, 1, idx[:, :, None].expand(-1, -1, full.shape[-1]))
    conv = _causal_conv(full, params, S, spec.d_conv, x.dtype)
    xs, bmat, cmat, dtf, A = _scan_inputs(params, conv, dt, di, n)
    live = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] < new_lens[:, None]
    dtf = torch.where(live[:, :, None], dtf, 0.0)
    xh = xs.reshape(B, S, h, p)
    y, _ = ops.ssd_scan(xh, dtf, A, bmat, cmat, chunk=_chunk(S),
                        init_state=ssm_cache, return_state=True, state_out=ssm_cache)
    conv_cache.copy_(conv_state)
    return _finish(params, y, xh, z, di)


def ssm_decode(params, x, cache, d_model: int, spec: SSMSpec):
    """One-token step; x (B, 1, d).  Returns the block output (B, 1, d);
    ``cache`` is advanced in place."""
    B = x.shape[0]
    di, h, n, p = spec.d_inner(d_model), spec.n_heads(d_model), spec.d_state, spec.head_dim

    proj = x[:, 0] @ params["w_in"]
    z, xs, bmat, cmat, dt = _split(proj, di, n, h)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)                 # (B, conv_dim)
    window = torch.cat([cache["conv"], xbc[:, None].to(cache["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    conv = F.silu(conv.float()).to(x.dtype)
    xs, bmat, cmat, dtf, A = _scan_inputs(params, conv, dt, di, n)
    xh = xs.reshape(B, h, p)
    y, new_state = ops.ssd_decode_step(xh, dtf, A, bmat, cmat, cache["ssm"])
    cache["ssm"].copy_(new_state)
    cache["conv"].copy_(window[:, 1:])
    y = y + params["d_skip"].to(y.dtype)[None, :, None] * xh
    y = _gated_rmsnorm(y.reshape(B, di), z, params["norm_scale"])
    return (y @ params["w_out"])[:, None]
