"""Attention blocks: param and cache defs, training, prefill, decode.

Counterpart of ``repro/models/attention.py``: GQA for every layer code —
full (``F``), global (``G``, with its own RoPE base when the spec has
one), sliding-window (``L``) and chunk-local (``C``) — and DeepSeek-V2's
multi-head latent attention (MLA).  An ``F``/``G`` cache holds
``max_len`` slots; an ``L`` cache is a ring of ``min(max_len, window)``
and a ``C`` cache a ring of ``min(max_len, 2 * chunk)``, each position
written at slot ``pos % size``.  An MLA cache holds each position's
``kv_lora``-wide latent and its rope key, shared by every head, at slot
``min(pos, max_len - 1)``; serving reads it through the **absorbed**
formulation (queries through ``w_k_b``, the context through ``w_v_b``),
so a decode step's reads scale with ``kv_lora + rope_head_dim``, not with
heads x head dims.

The KV cache is updated **in place**: a layer receives per-layer views of
the stacked cache tensors and writes through them.  That is the port's
counterpart of the reference's donated cache buffers — no cache-sized copy
per step.
"""

from __future__ import annotations

import torch

from repro_torch.configs import AttentionSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import CopyToModel, model_split, rope, row_parallel
from repro_torch.models.sharding import Param


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def attention_defs(d_model: int, spec: AttentionSpec) -> dict:
    if spec.kind == "mla":
        qk_head = spec.nope_head_dim + spec.rope_head_dim
        defs = {
            "w_kv_a": Param((d_model, spec.kv_lora), ("embed", "lora")),
            "w_k_rope": Param((d_model, spec.rope_head_dim), ("embed", None)),
            "w_k_b": Param(
                (spec.kv_lora, spec.n_heads, spec.nope_head_dim),
                ("lora", "heads", "head_dim"),
            ),
            "w_v_b": Param(
                (spec.kv_lora, spec.n_heads, spec.v_head_dim),
                ("lora", "heads", "head_dim"),
            ),
            "w_o": Param(
                (spec.n_heads, spec.v_head_dim, d_model),
                ("heads", "head_dim", "embed"),
            ),
        }
        if spec.q_lora:
            defs["w_q_a"] = Param((d_model, spec.q_lora), ("embed", "lora"))
            defs["w_q_b"] = Param(
                (spec.q_lora, spec.n_heads, qk_head),
                ("lora", "heads", "head_dim"),
            )
        else:
            defs["w_q"] = Param(
                (d_model, spec.n_heads, qk_head),
                ("embed", "heads", "head_dim"),
            )
        return defs
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

    An MLA layer caches ``ckv`` (batch, max_len, kv_lora) and ``krope``
    (batch, max_len, rope_head_dim); a GQA layer ``k`` and ``v`` (batch,
    kv heads, slots, head dim), ``L`` and ``C`` layers over rings.
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


def _kv_head(spec: AttentionSpec, tp) -> int | None:
    """The one kv head a rank's query heads map to when the divisibility
    drop replicates the kv heads over a ``model`` axis that splits the
    query heads (``rank * hq // g``); None when the kv heads split too.
    Raises ``NotImplementedError`` when the rank's query heads straddle
    GQA groups."""
    _, m, rank = tp
    if model_split("kv_heads", spec.n_kv_heads) is not None:
        return None
    hq, g = spec.n_heads // m, spec.n_heads // spec.n_kv_heads
    if g % hq:
        raise NotImplementedError(
            f"{spec.n_heads} query heads over a {m}-rank model axis put {hq} on a "
            f"rank, which straddle the GQA groups of {g} around the "
            f"{spec.n_kv_heads} replicated kv heads: not ported (ROADMAP A10b, rest)")
    return rank * hq // g


def _local_heads(params, spec: AttentionSpec, tp) -> dict:
    """The layer's params as a rank of a ``model`` axis that splits the
    query heads computes on in training: ``w_q``/``w_o`` are its shards
    already; ``w_k``/``w_v`` too when the kv heads split, else (the
    divisibility drop replicates them) the kv head its query heads map to
    (:func:`_kv_head`), sliced so that the GQA group stays whole.  A
    replicated leaf a rank uses in part (those slices, the q/k norms over
    its heads) passes :class:`~repro_torch.models.layers.CopyToModel`,
    which sums its gradient over the group."""
    group = tp[0]
    out = dict(params)
    for k in ("q_norm", "k_norm"):
        if k in out:
            out[k] = CopyToModel.apply(out[k], group)
    j = _kv_head(spec, tp)
    if j is not None:
        for k in ("w_k", "w_v"):
            out[k] = CopyToModel.apply(params[k], group)[:, j:j + 1]
    return out


def _attn_out(o: torch.Tensor, w_o: torch.Tensor, tp) -> torch.Tensor:
    """The block output of the heads' outputs ``o`` (B, H, S, k): one
    device's ``_merge_heads``, or under a ``model`` axis that splits the
    heads ``w_o``'s row-parallel product, which sums them over the
    group."""
    if tp is None:
        return _merge_heads(o, w_o)
    B, H, S, k = o.shape
    return row_parallel(o.transpose(1, 2).reshape(B, S, H * k), w_o.reshape(H * k, -1), tp[0])


def gqa_train(params, x, spec: AttentionSpec, code: str):
    """Full-sequence attention; x (B,S,D).  Under a mesh whose ``model``
    axis splits the query heads (Megatron), each rank projects and
    attends its own heads (:func:`_local_heads`) through the same kernel,
    and ``w_o``'s row-parallel product sums the heads over the group."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    tp = model_split("heads", spec.n_heads)
    if tp is not None:
        params = _local_heads(params, spec, tp)
        x = CopyToModel.apply(x, tp[0])
    q, k, v = _gqa_project(params, x, spec, positions, code)
    o = ops.attention(
        q, k, v,
        kind=_mask_kind(code), window=spec.window, chunk=spec.chunk,
    )
    return _attn_out(o, params["w_o"], tp)


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


def _serve_heads(spec: AttentionSpec):
    """(tp, kv head) of a serving step: the ``model`` split of the query
    heads (None on one device) and, where the kv heads are replicated over
    it, the one kv head this rank's query heads attend (:func:`_kv_head`).
    Every rank projects and writes every kv head it holds, so a
    replicated cache equals one device's."""
    tp = model_split("heads", spec.n_heads)
    return tp, (None if tp is None else _kv_head(spec, tp))


def gqa_prefill(params, x, cache, spec: AttentionSpec, code: str):
    """Whole-prompt attention + cache fill from position 0.

    Returns the block output; ``cache`` is filled in place.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    tp, j = _serve_heads(spec)
    q, k, v = _gqa_project(params, x, spec, positions, code)
    heads = slice(None) if j is None else slice(j, j + 1)
    o = ops.attention(
        q, k[:, heads], v[:, heads],
        kind=_mask_kind(code), window=spec.window, chunk=spec.chunk,
    )
    zeros = torch.zeros((B,), dtype=torch.int32, device=x.device)
    _append_kv(cache, k, v, zeros, zeros + S)
    return _attn_out(o, params["w_o"], tp)


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
    Under a ``model`` axis a rank attends its own query heads (with the
    one kv head they map to where the kv heads are replicated, read in
    place by the kernel) and ``w_o``'s row-parallel product sums the
    heads over the group.
    """
    B, S, _ = x.shape
    tp, kv_head = _serve_heads(spec)
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
        kind=_mask_kind(code), window=spec.window, chunk=spec.chunk, kv_head=kv_head,
    )
    _append_kv(cache, k_chunk, v_chunk, offsets, new_lens)
    return _attn_out(o, params["w_o"], tp)


def gqa_decode(params, x, cache, lengths, spec: AttentionSpec, code: str):
    """One-token decode; x (B,1,D); lengths (B,) tokens already cached.

    The new key/value is written into the cache (in place) at slot
    ``lengths % size`` *before* the attention.  An ``F``, ``G`` or ``L``
    layer then attends to the first ``min(lengths + 1, size)`` slots, as
    the reference does: a sliding ring of ``window`` slots holds exactly
    the window.  A ``C`` ring holds the previous chunk and the current
    one, so its slots are masked by the *position* each holds
    (``_ring_positions``): the query at ``lengths`` sees the keys of its
    own chunk, through the chunk-prefill kernel with one query.  (The
    reference masks a ``C`` layer to the first ``lengths % chunk + 1``
    slots, which is the current chunk only while a row is in its first
    one: ROADMAP C1.)  Under a ``model`` axis, as :func:`gqa_prefill_at`.
    Returns the block output.
    """
    B = x.shape[0]
    tp, kv_head = _serve_heads(spec)
    positions = lengths[:, None, None]           # (B,1,1) for (B,H,1,dh)
    q, k, v = _gqa_project(params, x, spec, positions, code)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]  # (B,H,D), (B,Hkv,D) x2

    size = cache["k"].shape[2]
    slot = (lengths % size).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, :, slot] = k.to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v.to(cache["v"].dtype)

    if code == "C" and spec.chunk:
        lengths = lengths.to(torch.int32)
        o = ops.prefill_attention(
            q[:, :, None].contiguous(), cache["k"], cache["v"],
            lengths[:, None].contiguous(), _ring_positions(lengths + 1, size),
            kind="chunked", chunk=spec.chunk, kv_head=kv_head,
        )[:, :, 0]
    else:
        valid = torch.clamp(lengths + 1, max=size)
        o = ops.decode_attention(
            q.contiguous(), cache["k"], cache["v"], valid.to(torch.int32), kv_head=kv_head,
        )
    return _attn_out(o[:, :, None], params["w_o"], tp)


# ---------------------------------------------------------------------------
# Apply: MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(params, x, spec, positions):
    """(qn, qr): the queries' no-rope and rope parts, (B, H, S, nope/rope)."""
    if "w_q_a" in params:
        q = _heads(x @ params["w_q_a"], params["w_q_b"])
    else:
        q = _heads(x, params["w_q"])
    qn = q[..., : spec.nope_head_dim]
    qr = rope(q[..., spec.nope_head_dim:], positions, spec.rope_theta)
    return qn, qr


def _mla_latent(params, x, spec, positions):
    """(ckv, kr): each position's latent (B, S, kv_lora) and its rope key
    (B, S, rope_head_dim), the key part every head shares."""
    ckv = x @ params["w_kv_a"]
    kr = rope(x @ params["w_k_rope"], positions, spec.rope_theta)
    return ckv, kr


def _mla_full(params, x, spec, positions, ckv, kr):
    """Full-sequence causal MLA over the unabsorbed heads: keys
    ``[ckv w_k_b, kr]`` (the rope key broadcast to every head), values
    ``ckv w_v_b``, through ``ops.attention`` at the q/k head dim
    ``nope + rope`` (its default scale) and the v head dim
    ``v_head_dim``."""
    qn, qr = _mla_q(params, x, spec, positions)
    kn = _heads(ckv, params["w_k_b"])
    v = _heads(ckv, params["w_v_b"])
    q = torch.cat([qn, qr], -1)
    k = torch.cat([kn, kr[:, None].expand(*kn.shape[:-1], spec.rope_head_dim)], -1)
    o = ops.attention(q, k, v, kind="causal")
    return _merge_heads(o, params["w_o"])


def mla_train(params, x, spec: AttentionSpec, code: str = "F"):
    """Full-sequence attention; x (B,S,D)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ckv, kr = _mla_latent(params, x, spec, positions)
    return _mla_full(params, x, spec, positions, ckv, kr)


def _append_latent(cache, ckv_new, kr_new, offsets, new_lens):
    """Offset-aware latent append, in place: row ``b`` writes its first
    ``new_lens[b]`` chunk entries at slots ``min(offsets[b] + j,
    Smax - 1)``.

    The reference scatters with ``mode="drop"``, routing the entries past
    ``new_lens`` out of bounds.  As in :func:`_append_kv`, the port writes
    a window instead: entry ``j``'s slot gets the chunk entry that lands
    there (for the clamped last slot, the last kept entry that reaches
    it, as the reference's scatter leaves it) or its own old value, so a
    row with ``new_lens == 0`` keeps its cache bit for bit and nothing
    stalls the host.
    """
    Smax = cache["ckv"].shape[1]
    B, S, _ = ckv_new.shape
    j = torch.arange(S, dtype=torch.int64, device=ckv_new.device)[None, :]
    off = offsets.long()[:, None]
    nl = new_lens.long()[:, None]
    last = Smax - 1
    inside = off + j < last
    slot = torch.clamp(off + j, max=last)                     # (B, S)
    src = torch.where(inside, j, nl - 1)
    take = (src >= 0) & (src < nl) & (inside | (off + src >= last))
    src = src.clamp(0, S - 1)
    bidx = torch.arange(B, device=ckv_new.device)[:, None]
    for name, new in (("ckv", ckv_new), ("krope", kr_new)):
        buf = cache[name]
        old = buf[bidx, slot]                                 # (B, S, w)
        fresh = new[bidx, src].to(buf.dtype)
        buf[bidx, slot] = torch.where(take[:, :, None], fresh, old)


def mla_prefill(params, x, cache, spec: AttentionSpec, code: str = "F"):
    """Whole-prompt attention + latent cache fill from position 0.

    Returns the block output; ``cache`` is filled in place.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    ckv, kr = _mla_latent(params, x, spec, positions)
    out = _mla_full(params, x, spec, positions, ckv, kr)
    zeros = torch.zeros((B,), dtype=torch.int32, device=x.device)
    _append_latent(cache, ckv, kr, zeros, zeros + S)
    return out


def _bmm_f32(a, b):
    """``a @ b`` (batched) summed in float32, the operands in their own
    dtype: the reference's ``preferred_element_type=float32``.  On the card
    a bfloat16 product is one cuBLAS call with a float32 output
    (``out_dtype``), so the streamed cache is never copied to float32; the
    CPU has no such kernel, and multiplies float32 copies (a bfloat16
    product is exact in float32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _per_head(t, wh):
    """einsum("bhsk,hkr->bhsr") as one product per head: ``t`` (B, H, S,
    k), ``wh`` an (H, k, r) view of a weight as it lies (a strided view,
    which cuBLAS reads in place: no permuted copy of the weight).  Returns
    (B, H, S, r) in ``t``'s dtype."""
    B, H, S, k = t.shape
    out = torch.bmm(t.transpose(0, 1).reshape(H, B * S, k), wh)
    return out.view(H, B, S, -1).transpose(0, 1)


def _mla_absorbed(params, qn, qr, cache, positions, spec, out_dtype):
    """The absorbed attention of queries at ``positions`` (B, S) against
    the whole latent cache, masked to slots ``< min(pos + 1, Smax)``:
    ``q_abs = qn w_k_b`` in the cache's dtype, scores ``(q_abs ckv^T +
    qr kr^T) (nope + rope)^-0.5`` summed in float32 from the cache as it
    lies, a float32 softmax, ``p`` in the cache's dtype, the context
    ``p ckv`` summed in float32 and cast to ``out_dtype``, then ``w_v_b``
    and ``w_o``.  The reference's ``mla_decode`` is the case S = 1."""
    ckv, kr = cache["ckv"], cache["krope"]
    B, H, S, _ = qn.shape
    Smax = ckv.shape[1]
    q_abs = _per_head(qn, params["w_k_b"].permute(1, 2, 0)).to(ckv.dtype)
    scores = _bmm_f32(q_abs.reshape(B, H * S, -1), ckv.transpose(1, 2))
    scores.add_(_bmm_f32(qr.to(kr.dtype).reshape(B, H * S, -1), kr.transpose(1, 2)))
    scores.mul_((spec.nope_head_dim + spec.rope_head_dim) ** -0.5)
    kpos = torch.arange(Smax, dtype=torch.int32, device=ckv.device)
    limit = torch.clamp(positions + 1, max=Smax)                       # (B, S)
    dead = kpos[None, None, None, :] >= limit[:, None, :, None]        # (B, 1, S, Smax)
    scores = scores.view(B, H, S, Smax).masked_fill_(dead, -1e30)
    p = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx = _bmm_f32(p.view(B, H * S, Smax), ckv).to(out_dtype)         # (B, H*S, r)
    o = _per_head(ctx.view(B, H, S, -1), params["w_v_b"].permute(1, 0, 2))
    return _merge_heads(o, params["w_o"])


def mla_prefill_at(
    params, x, cache, offsets, new_lens, spec: AttentionSpec, code: str = "F"
):
    """Offset-aware absorbed-MLA chunk prefill (decode-replay semantics).

    Unlike :func:`gqa_prefill_at`, the chunk's latents are written into
    the cache first (slot == position), and then the chunk's queries run
    the absorbed formulation against the *updated* cache, masked by
    absolute position — the score layout, dtype path and summation order
    of :func:`mla_decode`, as in the reference.  Rows with ``new_lens ==
    0`` keep their cache.  Returns the block output.
    """
    S = x.shape[1]
    offsets = offsets.to(torch.int32)
    positions = offsets[:, None] + torch.arange(S, dtype=torch.int32,
                                                device=x.device)[None, :]
    qn, qr = _mla_q(params, x, spec, positions[:, None, :])
    ckv_new, kr_new = _mla_latent(params, x, spec, positions)
    _append_latent(cache, ckv_new, kr_new, offsets, new_lens.to(torch.int32))
    return _mla_absorbed(params, qn, qr, cache, positions, spec, x.dtype)


def mla_decode(params, x, cache, lengths, spec: AttentionSpec, code: str = "F"):
    """Absorbed MLA decode: x (B,1,D); lengths (B,) tokens already cached.

    The new latent and rope key are written (in place) at slot
    ``min(lengths, Smax - 1)`` before the attention, which reads the
    latent cache in its storage dtype: its reads scale with ``kv_lora +
    rope_head_dim``, not with heads x head dims.  Returns the block
    output.
    """
    B = x.shape[0]
    positions = lengths[:, None]                                  # (B, 1)
    qn, qr = _mla_q(params, x, spec, positions[:, None])
    ckv_new, kr_new = _mla_latent(params, x, spec, positions)
    Smax = cache["ckv"].shape[1]
    slot = torch.clamp(lengths, max=Smax - 1).long()
    bidx = torch.arange(B, device=x.device)
    cache["ckv"][bidx, slot] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["krope"][bidx, slot] = kr_new[:, 0].to(cache["krope"].dtype)
    return _mla_absorbed(params, qn, qr, cache, positions, spec, x.dtype)


# ---------------------------------------------------------------------------
# Unified dispatch
# ---------------------------------------------------------------------------

def attn_train(params, x, spec, code):
    if spec.kind == "mla":
        return mla_train(params, x, spec, code)
    return gqa_train(params, x, spec, code)


def attn_prefill(params, x, cache, spec, code):
    if spec.kind == "mla":
        return mla_prefill(params, x, cache, spec, code)
    return gqa_prefill(params, x, cache, spec, code)


def attn_prefill_at(params, x, cache, offsets, new_lens, spec, code):
    if spec.kind == "mla":
        return mla_prefill_at(params, x, cache, offsets, new_lens, spec, code)
    return gqa_prefill_at(params, x, cache, offsets, new_lens, spec, code)


def attn_decode(params, x, cache, lengths, spec, code):
    if spec.kind == "mla":
        return mla_decode(params, x, cache, lengths, spec, code)
    return gqa_decode(params, x, cache, lengths, spec, code)
