"""GQA attention blocks: param and cache defs, training, prefill, decode.

Counterpart of the GQA half of ``repro/models/attention.py``; MLA and the
ring caches of sliding-window (``L``) and chunked (``C``) layers are
still to be ported: every cache here holds ``max_len`` slots, as a
full-attention (``F``) layer's does.

The KV cache is updated **in place**: a layer receives per-layer views of
the stacked cache tensors and writes through them.  That is the port's
counterpart of the reference's donated cache buffers — no cache-sized copy
per step.
"""

from __future__ import annotations

import torch

from repro_torch.configs import AttentionSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.models.sharding import Param


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def attention_defs(d_model: int, spec: AttentionSpec) -> dict:
    if spec.kind == "mla":
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP queue A)"
        )
    defs = {
        "w_q": Param(
            (d_model, spec.n_heads, spec.d_head),
            ("embed", "heads", "head_dim"),
        ),
        "w_k": Param(
            (d_model, spec.n_kv_heads, spec.d_head),
            ("embed", "kv_heads", "head_dim"),
        ),
        "w_v": Param(
            (d_model, spec.n_kv_heads, spec.d_head),
            ("embed", "kv_heads", "head_dim"),
        ),
        "w_o": Param(
            (spec.n_heads, spec.d_head, d_model),
            ("heads", "head_dim", "embed"),
        ),
    }
    if spec.qk_norm:
        defs["q_norm"] = Param((spec.d_head,), (None,), init="ones")
        defs["k_norm"] = Param((spec.d_head,), (None,), init="ones")
    return defs


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _mask_kind(code: str) -> str:
    return {"F": "causal", "G": "causal", "L": "sliding", "C": "chunked",
            "X": "bidirectional"}[code]


def _theta(spec: AttentionSpec, code: str) -> float:
    if code == "G" and spec.rope_theta_global:
        return spec.rope_theta_global
    return spec.rope_theta


# ---------------------------------------------------------------------------
# Cache defs
# ---------------------------------------------------------------------------

def cache_defs(
    batch: int, max_len: int, spec: AttentionSpec, code: str = "F"
) -> dict:
    """Per-layer decode-cache defs (Param reused as a shaped placeholder).

    Every layer code and the MLA cache are described, as the reference
    does, so the planner can size any config's cache; the port's model
    applies only ``F``-code GQA caches (``ModelBundle`` refuses the rest).
    """
    if spec.kind == "mla":
        return {
            "ckv": Param(
                (batch, max_len, spec.kv_lora),
                ("batch", "kv_seq", "lora"), init="zeros",
            ),
            "krope": Param(
                (batch, max_len, spec.rope_head_dim),
                ("batch", "kv_seq", None), init="zeros",
            ),
        }
    size = min(max_len, spec.window) if code == "L" and spec.window else max_len
    if code == "C" and spec.chunk:
        size = min(max_len, 2 * spec.chunk)  # ring over current+prev chunk
    return {
        "k": Param(
            (batch, spec.n_kv_heads, size, spec.d_head),
            ("batch", "kv_heads", "kv_seq", "head_dim"), init="zeros",
        ),
        "v": Param(
            (batch, spec.n_kv_heads, size, spec.d_head),
            ("batch", "kv_heads", "kv_seq", "head_dim"), init="zeros",
        ),
    }


# ---------------------------------------------------------------------------
# Apply: GQA
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bhsk"): (B, S, d) x (d, H, k) -> (B, H, S, k)."""
    B, S, _ = x.shape
    d, H, k = w.shape
    return (x @ w.reshape(d, H * k)).view(B, S, H, k).transpose(1, 2)


def _merge_heads(o: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """einsum("bhsk,hkd->bsd"): (B, H, S, k) x (H, k, d) -> (B, S, d)."""
    B, H, S, k = o.shape
    return o.transpose(1, 2).reshape(B, S, H * k) @ w_o.reshape(H * k, -1)


def _gqa_project(params, x, spec, positions, code):
    q = _heads(x, params["w_q"])
    k = _heads(x, params["w_k"])
    v = _heads(x, params["w_v"])
    if spec.qk_norm:
        q = _rms(q, params["q_norm"])
        k = _rms(k, params["k_norm"])
    th = _theta(spec, code)
    return rope(q, positions, th), rope(k, positions, th), v


def gqa_train(params, x, spec: AttentionSpec, code: str):
    """Full-sequence attention; x (B,S,D)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _gqa_project(params, x, spec, positions, code)
    o = ops.attention(
        q, k, v,
        kind=_mask_kind(code), window=spec.window, chunk=spec.chunk,
    )
    return _merge_heads(o, params["w_o"])


def _ring_positions(offsets: torch.Tensor, size: int) -> torch.Tensor:
    """Absolute position held by each ring slot *before* a chunk append.

    ``offsets`` (B,) is each row's cache fill.  Slot ``r`` holds the
    largest position ``p ≡ r (mod size)`` with ``p < offsets``; a negative
    result marks a hole (never-written slot).  For non-ring caches
    (``size >= max_len``) this is ``p = r`` for ``r < offsets``.
    """
    r = torch.arange(size, dtype=torch.int32, device=offsets.device)[None, :]
    return r + size * torch.div(offsets[:, None] - 1 - r, size,
                                rounding_mode="floor")


def _append_kv(cache, k_new, v_new, offsets, new_lens):
    """Offset-aware KV append, in place: row ``b`` writes positions
    ``[offsets[b], offsets[b] + new_lens[b])`` at ring slots
    ``pos % size``.

    The reference scatters with ``mode="drop"``, routing entries past
    ``new_lens`` (and, when the chunk outruns the ring, entries the chunk
    itself overwrites) to an out-of-bounds slot.  Torch has no drop mode,
    and selecting the kept (b, j) pairs with ``nonzero`` would stall the
    host on the device once per layer.  So the kept pairs are selected
    per *slot* instead: the window of ``min(S, size)`` slots from each
    row's offset is distinct, the slot's one kept chunk entry (if any) is
    computed arithmetically, and every other slot of the window is
    written back with its own old value.  One ``index_put_`` per leaf, no
    duplicate indices, nothing outside the window touched — a row with
    ``new_lens == 0`` keeps its cache bit for bit.
    """
    size = cache["k"].shape[2]
    B, _, S, _ = k_new.shape
    W = min(S, size)
    j = torch.arange(W, dtype=torch.int64, device=k_new.device)[None, :]
    off = offsets.long()[:, None]
    nl = new_lens.long()[:, None]
    slot = (off + j) % size                                   # (B, W), distinct
    lo = (nl - size).clamp(min=0)                             # first kept entry
    src = lo + (j - lo) % size                                # kept entry ≡ j (mod size)
    take = src < nl
    src = src.clamp(max=S - 1)
    bidx = torch.arange(B, device=k_new.device)[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        old = buf[bidx, :, slot]                              # (B, W, H, D)
        fresh = new.transpose(1, 2)[bidx, src].to(buf.dtype)  # (B, W, H, D)
        buf[bidx, :, slot] = torch.where(take[:, :, None, None], fresh, old)


def gqa_prefill(params, x, cache, spec: AttentionSpec, code: str):
    """Whole-prompt attention + cache fill from position 0.

    Returns the block output; ``cache`` is filled in place.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _gqa_project(params, x, spec, positions, code)
    o = ops.attention(
        q, k, v,
        kind=_mask_kind(code), window=spec.window, chunk=spec.chunk,
    )
    zeros = torch.zeros((B,), dtype=torch.int32, device=x.device)
    _append_kv(cache, k, v, zeros, zeros + S)
    return _merge_heads(o, params["w_o"])


def gqa_prefill_at(
    params, x, cache, offsets, new_lens, spec: AttentionSpec, code: str
):
    """Offset-aware chunk prefill: continue each row's cache in one pass.

    ``x`` (B, S, D) holds one prefill chunk; row ``b`` appends
    ``new_lens[b] <= S`` tokens at positions ``offsets[b]..``.  Queries
    attend causally within the chunk and fully (windowed / chunk-locally,
    by absolute position) against the prior cache.  The attention reads
    the *old* cache and the chunk as two key sources — no concatenation —
    and the append comes after it.  Rows with ``new_lens == 0`` are
    untouched.  Returns the block output; ``cache`` is updated in place.
    """
    B, S, _ = x.shape
    offsets = offsets.to(torch.int32)
    new_lens = new_lens.to(torch.int32)
    j = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    positions = offsets[:, None] + j
    q, k, v = _gqa_project(params, x, spec, positions[:, None, :], code)

    size = cache["k"].shape[2]
    kpos_new = torch.where(j < new_lens[:, None], positions, -1)
    kpos = torch.cat([_ring_positions(offsets, size), kpos_new], dim=1)
    # keys are compared in the cache's storage dtype, as decode sees them
    k_chunk = k.to(cache["k"].dtype).contiguous()
    v_chunk = v.to(cache["v"].dtype).contiguous()
    o = ops.prefill_attention(
        q.contiguous(), cache["k"], cache["v"], positions, kpos,
        k_new=k_chunk, v_new=v_chunk,
        kind=_mask_kind(code), window=spec.window, chunk=spec.chunk,
    )
    _append_kv(cache, k_chunk, v_chunk, offsets, new_lens)
    return _merge_heads(o, params["w_o"])


def gqa_decode(params, x, cache, lengths, spec: AttentionSpec, code: str):
    """One-token decode; x (B,1,D); lengths (B,) tokens already cached.

    The new key/value is written into the cache (in place) *before* the
    attention, which then sees ``min(lengths + 1, size)`` entries.
    Returns the block output.
    """
    B = x.shape[0]
    positions = lengths[:, None, None]           # (B,1,1) for (B,H,1,dh)
    q, k, v = _gqa_project(params, x, spec, positions, code)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]  # (B,H,D), (B,Hkv,D) x2

    size = cache["k"].shape[2]
    slot = (lengths % size).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, :, slot] = k.to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v.to(cache["v"].dtype)

    valid = torch.clamp(lengths + 1, max=size)
    o = ops.decode_attention(
        q.contiguous(), cache["k"], cache["v"], valid.to(torch.int32)
    )
    return _merge_heads(o[:, :, None], params["w_o"])
