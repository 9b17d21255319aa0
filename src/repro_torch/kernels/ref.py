"""Plain PyTorch versions of the attention, SSD, GEMM, membench and KV
write-back kernels.

Counterpart of ``repro/kernels/ref.py``.  These are the correctness
references the CUDA kernels are held to (``chip_smoke.py`` and the card
tests), and the path every CPU tensor takes through
:mod:`repro_torch.kernels.ops`.  Softmax and the SSD recurrence run in
float32 whatever the input dtype, as in the kernels.

Mask kinds:

* ``causal``        — standard decoder mask
* ``sliding``       — causal ∧ (q - k < window)
* ``chunked``       — causal ∧ same-chunk(q, k)
* ``bidirectional`` — none
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked rows
                 # (sliding windows near t=0, padded decode) NaN-free.


def mask_fn(
    kind: str,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    window: int = 0,
    chunk: int = 0,
) -> torch.Tensor:
    """Boolean mask (True = attend) for positions q_pos x k_pos."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if kind == "bidirectional":
        return torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                          dtype=torch.bool, device=q.device)
    causal = q >= k
    if kind == "causal":
        return causal
    if kind == "sliding":
        return causal & (q - k < window)
    if kind == "chunked":
        return causal & (torch.div(q, chunk, rounding_mode="floor")
                         == torch.div(k, chunk, rounding_mode="floor"))
    raise ValueError(f"unknown mask kind {kind!r}")


def attention(
    q: torch.Tensor,          # (B, Hq, Sq, D)
    k: torch.Tensor,          # (B, Hkv, Sk, D)
    v: torch.Tensor,          # (B, Hkv, Sk, Dv)
    *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
    k_lengths: torch.Tensor | None = None,  # (B,) valid KV length (decode)
) -> torch.Tensor:
    """Grouped-query attention.

    ``q_offset`` places the query block inside the global position space;
    ``k_lengths`` masks cache tail slots.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale

    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    m = mask_fn(kind, q_pos, k_pos, window=window, chunk=chunk)
    if k_lengths is not None:
        valid = k_pos[None, :] < k_lengths[:, None]            # (B, Sk)
        m = m[None, :, :] & valid[:, None, :]
        m = m[:, None, None]                                    # (B,1,1,Sq,Sk)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, Dv).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
    block_q: int = 512,
) -> torch.Tensor:
    """Flash-style memory profile in plain PyTorch: loop over query blocks.

    Identical math to :func:`attention`; the peak live intermediate is one
    (B, H, block_q, Sk) score block instead of the full (Sq, Sk) matrix,
    and each block is recomputed in the backward (``checkpoint``) instead
    of saving every block's f32 probabilities.  The reference's mesh-aware
    shrinking of ``block_q`` has no counterpart: the port runs on one
    device.
    """
    Sq = q.shape[2]
    bq = min(block_q, Sq)
    assert Sq % bq == 0, (Sq, bq)

    def one(qi, i):
        return attention(qi, k, v, kind=kind, window=window, chunk=chunk,
                         scale=scale, q_offset=q_offset + i * bq)

    outs = [
        checkpoint(one, q[:, :, i * bq:(i + 1) * bq], i, use_reentrant=False)
        for i in range(Sq // bq)
    ]
    return torch.cat(outs, dim=2)


def prefill_mask(
    q_pos: torch.Tensor,      # (B, Sq)
    k_pos: torch.Tensor,      # (B, Sk); < 0 = hole
    *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
) -> torch.Tensor:
    """(B, Sq, Sk) bool: the live (query, key) pairs of
    :func:`prefill_attention` — ``q_pos >= k_pos >= 0``, plus
    ``q_pos - k_pos < window`` (sliding) or the same ``pos // chunk``
    (chunked)."""
    qp = q_pos[:, :, None]                       # (B, Sq, 1)
    kp = k_pos[:, None, :]                       # (B, 1, Sk)
    m = (qp >= kp) & (kp >= 0)
    if kind == "sliding":
        m &= (qp - kp) < window
    elif kind == "chunked":
        m &= (torch.div(qp, chunk, rounding_mode="floor")
              == torch.div(kp, chunk, rounding_mode="floor"))
    elif kind != "causal":
        raise ValueError(f"prefill mask kind {kind!r}")
    return m


def prefill_attention(
    q: torch.Tensor,          # (B, Hq, Sq, D) — one prefill chunk of queries
    k: torch.Tensor,          # (B, Hkv, Sk, D) — prior cache ++ chunk keys
    v: torch.Tensor,          # (B, Hkv, Sk, Dv)
    q_pos: torch.Tensor,      # (B, Sq) absolute position of each query
    k_pos: torch.Tensor,      # (B, Sk) absolute position of each key; < 0 = hole
    *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention on explicit positions.

    Masking is on *absolute* positions: causal within the chunk, full (or
    windowed / chunk-local) against the prior cache; ``k_pos < 0`` marks
    invalid slots.  A query row with no live key gets the mean of V over
    all keys (uniform softmax over ``NEG_INF`` scores) — such rows are
    padding and callers discard them.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale

    m = prefill_mask(q_pos, k_pos, kind=kind, window=window, chunk=chunk)
    s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, Dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # (B, Hq, D) — one new token
    k_cache: torch.Tensor,    # (B, Hkv, Smax, D)
    v_cache: torch.Tensor,    # (B, Hkv, Smax, Dv)
    lengths: torch.Tensor,    # (B,) valid entries per batch row
    *,
    scale: float | None = None,
    kv_head: int | None = None,
) -> torch.Tensor:
    """Single-token decode against a (possibly padded) KV cache; with
    ``kv_head`` against that one head of it (a slice)."""
    if kv_head is not None:
        k_cache = k_cache[:, kv_head:kv_head + 1]
        v_cache = v_cache[:, kv_head:kv_head + 1]
    out = attention(
        q[:, :, None, :], k_cache, v_cache,
        kind="bidirectional", scale=scale, k_lengths=lengths,
    )
    return out[:, :, 0, :]


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) — arXiv:2405.21060
# ---------------------------------------------------------------------------

def ssd_scan(
    x: torch.Tensor,      # (B, T, H, P)   inputs per head
    dt: torch.Tensor,     # (B, T, H)      softplus-activated step sizes
    A: torch.Tensor,      # (H,)           negative decay rates
    Bmat: torch.Tensor,   # (B, T, N)      input projections (shared across heads)
    Cmat: torch.Tensor,   # (B, T, N)      output projections
    *,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
    return_state: bool = False,
):
    """Chunked SSD: O(T/c · c² + T·N), the paper's algorithm.

    The recurrence (per head, channel p, state n):
        h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t[n] · x_t[p]
        y_t = Σ_n C_t[n] · h_t[p, n]

    The intra-chunk term is a masked quadratic form (the attention dual);
    the inter-chunk term carries the state.  All arithmetic is float32; y
    comes back in x's dtype, the state in float32.
    """
    Bsz, T, H, Pdim = x.shape
    N = Bmat.shape[-1]
    assert T % chunk == 0, (T, chunk)
    nc = T // chunk

    xc = x.float().reshape(Bsz, nc, chunk, H, Pdim)
    dtc = dt.float().reshape(Bsz, nc, chunk, H)
    Bc = Bmat.float().reshape(Bsz, nc, chunk, N)
    Cc = Cmat.float().reshape(Bsz, nc, chunk, N)

    # per-position log decay a_t = A · dt_t (negative), inclusive cumsum
    cum = torch.cumsum(A.float() * dtc, dim=2)                # (B,C,c,H)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j (decay j+1..i).
    # Double-where: masked entries have cum_i - cum_j > 0 and exp would
    # overflow; zeroing the exponent first keeps them (and a gradient) finite.
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    delta = torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0)
    L = torch.where(mask, torch.exp(delta), 0.0)              # (B,C,c,c,H)

    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)               # C_i · B_j
    M = G[..., None] * L
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", M, dtc, xc)

    # chunk summaries: S_k[h,p,n] = Σ_j exp(cum_last - cum_j) dt_j x_j[p] B_j[n]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,C,c,H)
    S = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", decay_to_end, dtc, xc, Bc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,C,H)

    # inter-chunk recurrence over the chunks (the reference's lax.scan)
    h = (init_state.float() if init_state is not None
         else x.new_zeros((Bsz, H, Pdim, N), dtype=torch.float32))
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    hb = torch.stack(h_before, dim=1)                         # (B,C,H,P,N)

    # inter-chunk output: y_inter[i] = C_i · (exp(cum_i) · h_before)
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cum), hb)

    y = (y_intra + y_inter).reshape(Bsz, T, H, Pdim).to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_scan_bwd(
    x, dt, A, Bmat, Cmat, dy, *,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,
    d_state_out: torch.Tensor | None = None,
):
    """Gradients of :func:`ssd_scan` by autograd through it: the plain
    version of the backward kernel.

    ``dy`` (B, T, H, P) is the gradient of ``y``; ``d_state_out`` (B, H, P,
    N), when given, that of the returned final state.  Returns ``(dx, ddt,
    dA, dB, dC, d_init_state)`` in the inputs' dtypes; ``d_init_state`` is
    None without an ``init_state``.
    """
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bmat, Cmat)]
        h0 = None if init_state is None else init_state.detach().requires_grad_()
        y, h = ssd_scan(*ins, chunk=chunk, init_state=h0, return_state=True)
        outs, grads = [y], [dy]
        if d_state_out is not None:
            outs.append(h)
            grads.append(d_state_out)
        got = torch.autograd.grad(outs, ins + ([] if h0 is None else [h0]), grads)
    return (*got[:5], got[5] if h0 is not None else None)


def ssd_decode_step(
    x: torch.Tensor,       # (B, H, P)
    dt: torch.Tensor,      # (B, H)
    A: torch.Tensor,       # (H,)
    Bvec: torch.Tensor,    # (B, N)
    Cvec: torch.Tensor,    # (B, N)
    state: torch.Tensor,   # (B, H, P, N) float32
):
    """One recurrence step (the decode path).  Returns (y, new_state)."""
    xf, dtf = x.float(), dt.float()
    dec = torch.exp(A[None, :] * dtf)                         # (B,H)
    add = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bvec.float())
    new_state = state * dec[:, :, None, None] + add
    y = torch.einsum("bn,bhpn->bhp", Cvec.float(), new_state)
    return y.to(x.dtype), new_state


def ssd_scan_sequential(x, dt, A, Bmat, Cmat, *, init_state=None):
    """O(T) literal recurrence — the oracle's oracle."""
    Bsz, T, H, Pdim = x.shape
    N = Bmat.shape[-1]
    h = (init_state.float() if init_state is not None
         else x.new_zeros((Bsz, H, Pdim, N), dtype=torch.float32))
    ys = []
    for t in range(T):
        y, h = ssd_decode_step(x[:, t], dt[:, t], A, Bmat[:, t], Cmat[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# Blocked matmul (the paper's GEMM study) and the memory microbenchmarks
# ---------------------------------------------------------------------------

def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """f32-accumulating matmul oracle: the product of the operands in f32,
    cast to ``out_dtype`` (default: the operands' dtype)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def stream_read(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` as a float64 scalar (the read kernel's result)."""
    return x.sum(dtype=torch.float64)


def stream_fill(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x`` with every element set to ``value``, in place."""
    return x.fill_(value)


def chase(perm: torch.Tensor, steps: int, pos: torch.Tensor) -> torch.Tensor:
    """``idx = perm[idx]`` ``steps`` times from the index in ``pos`` (one
    int32), the last index written back to ``pos``, which is returned.
    Each step is a separate indexing op."""
    p = perm.to(pos.device).long()
    idx = pos.reshape(()).long()
    for _ in range(steps):
        idx = p[idx]
    return pos.copy_(idx.reshape(pos.shape))


# ---------------------------------------------------------------------------
# KV write-back into the host tier (no Pallas original: csrc/kv_stream.cu)
# ---------------------------------------------------------------------------

def kv_write_back(
    src_k: torch.Tensor,      # (B, H, S, D) the layer's staging window
    src_v: torch.Tensor,
    dst_k: torch.Tensor,      # (B, H, S, D) the layer's slab of the cache
    dst_v: torch.Tensor,
    pos: torch.Tensor,        # (B,) int32 first position each row wrote
    n: torch.Tensor,          # (B,) int32 positions each row wrote
) -> None:
    """Copy the rows a step wrote from ``src`` into ``dst``, in place: per
    row ``b`` the positions ``[pos[b], pos[b] + n[b])`` modulo ``S`` for
    every head (only the last ``S`` when ``n[b] > S``; nothing when
    ``n[b] == 0``).  ``src`` and ``dst`` may lie on different devices:
    the rows are gathered on ``src``'s and scattered on ``dst``'s."""
    B, H, S, D = src_k.shape
    cnt = n.long().clamp(min=0)
    W = cnt.clamp(max=S)
    j = torch.arange(S, device=src_k.device)[None, :]             # (1, S)
    slot = (pos.long()[:, None] + cnt[:, None] - W[:, None] + j) % S
    take = j < W[:, None]                                         # (B, S)
    rows = torch.arange(B, device=src_k.device)[:, None].expand(B, S)[take]
    slots = slot[take]
    for src, dst in ((src_k, dst_k), (src_v, dst_v)):
        picked = src[rows, :, slots]                              # (R, H, D)
        dst[rows.to(dst.device), :, slots.to(dst.device)] = picked.to(dst.device)
