"""Blocked GQA attention: the CUDA kernels and their wrappers.

Counterpart of ``repro/kernels/flash_attention.py``:

* :func:`flash_attention` — full-sequence attention for training and
  whole-prompt prefill (``repro_torch/csrc/flash_attention.cu``), with
  :func:`flash_attention_bwd`, its backward, at the head dims of
  :data:`FA_HEAD_DIMS`: q/k and v of one width, or MLA's q/k of 192 with
  v of 128.  The plain version of the same function is
  :func:`repro_torch.kernels.ref.attention`, and of the backward
  ``torch.autograd.grad`` through it; :func:`smem_footprint_bytes` gives
  the shared memory its bf16 kernels take.
* :func:`flash_prefill` — chunked-prefill attention on explicit positions
  (``repro_torch/csrc/prefill_attention.cu``).  Unlike the Pallas kernel
  it reads keys from two sources — the prior cache and the chunk's own
  keys — so the model no longer concatenates them.  Its plain version is
  :func:`repro_torch.kernels.ref.prefill_attention` over the
  concatenation.  :func:`prefill_tile_class` mirrors how its bf16 kernel
  sorts (warp, key tile) pairs into empty, full and partial, and
  :func:`prefill_smem_bytes` gives the shared memory that kernel takes.

Each kernel is built with ``nvcc`` on first use.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked_matmul import SMEM_BUDGET
from repro_torch.kernels.decode_attention import (
    DTYPE_CODES,
    SUPPORTED_D,
    check_operands,
)

MASK_KINDS = {"causal": 0, "sliding": 1, "chunked": 2}
#: mask codes of the full-sequence kernel (csrc/flash_attention.cu)
FA_MASK_KINDS = {"causal": 0, "sliding": 1, "chunked": 2, "bidirectional": 3}
#: the (q/k, v) head dims the full-sequence kernels take, by dtype
#: (csrc/flash_attention.cu: takes_head_dims); MLA's (192, 128) has bf16
#: tensor-core kernels only
FA_HEAD_DIMS = {
    torch.float32: tuple((d, d) for d in SUPPORTED_D),
    torch.bfloat16: tuple((d, d) for d in SUPPORTED_D) + ((192, 128),),
}

_fn = None
_fa_fns = None


def _fa_launchers():
    global _fa_fns
    if _fa_fns is None:
        lib = _build.load("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        fwd = lib.flash_attention_fwd_launch
        fwd.argtypes = [P] * 5 + [I] * 12 + [ctypes.c_float, P]
        fwd.restype = I
        bwd = lib.flash_attention_bwd_launch
        bwd.argtypes = [P] * 10 + [I] * 12 + [ctypes.c_float, P]
        bwd.restype = I
        _fa_fns = fwd, bwd
    return _fa_fns


def fa_head_dims(dtype: torch.dtype, d: int, dv: int) -> tuple[int, int]:
    """The head dims a (q/k ``d``, v ``dv``) attention runs at in the
    kernels: the smallest pair of :data:`FA_HEAD_DIMS` at least as wide in
    both, which is ``(d, dv)`` itself when the kernels take it.  Raises
    when none is."""
    if dtype not in FA_HEAD_DIMS:
        raise TypeError(f"the attention kernels take float32 or bfloat16, got {dtype}")
    fits = [p for p in FA_HEAD_DIMS[dtype] if p[0] >= d and p[1] >= dv]
    if not fits:
        raise ValueError(f"head dims (q/k {d}, v {dv}): no {dtype} attention kernel "
                         f"takes them or a wider pair ({FA_HEAD_DIMS[dtype]})")
    return min(fits)


def _fa_check(q, k, v, kind, window, chunk, name):
    """Shapes (B, Hq, Sq, D) / (B, Hkv, Sk, D) / (B, Hkv, Sk, Dv) and the
    mask arguments; raises on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if kind not in FA_MASK_KINDS:
        raise ValueError(f"mask kind {kind!r}")
    if kind == "sliding" and window <= 0:
        raise ValueError("sliding mask needs window > 0")
    if kind == "chunked" and chunk <= 0:
        raise ValueError("chunked mask needs chunk > 0")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if (D, Dv) not in FA_HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dims (q/k {D}, v {Dv}) not in "
                         f"{FA_HEAD_DIMS[q.dtype]} for {q.dtype}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if min(B, Sq, Sk) <= 0 or max(B, Hq) > 65535:
        raise ValueError(f"empty or oversized shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    check_operands({"q": q, "k": k, "v": v}, dtype=q.dtype, device=q.device)
    return B, Hq, Hkv, Sq, Sk, D, Dv


def flash_attention(
    q: torch.Tensor,        # (B, Hq, Sq, D)
    k: torch.Tensor,        # (B, Hkv, Sk, D)
    v: torch.Tensor,        # (B, Hkv, Sk, Dv)
    *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on ``q``'s device and current stream.

    Query ``i`` sits at position ``q_offset + i``, key ``j`` at ``j``.
    Returns ``(out, lse)``: ``out`` (B, Hq, Sq, Dv) in q's dtype — 0 on a
    row with no live key — and the row log-sum-exp of the scaled scores,
    ``lse`` (B, Hq, Sq) float32, which the backward reads.
    """
    B, Hq, Hkv, Sq, Sk, D, Dv = _fa_check(q, k, v, kind, window, chunk,
                                          "flash_attention")
    scale = D ** -0.5 if scale is None else float(scale)
    fwd, _ = _fa_launchers()
    out = q.new_empty((B, Hq, Sq, Dv))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D, Dv, DTYPE_CODES[q.dtype],
            FA_MASK_KINDS[kind], int(window), int(chunk), int(q_offset), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    flash_attention.by_shape[kind, Sq, Sk] += 1
    return out, lse


def flash_attention_bwd(
    q, k, v, out, lse, dout, *,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels: ``(dq, dk, dv)`` of :func:`flash_attention`
    for the cotangent ``dout``, from its ``out`` and ``lse``.

    Two or three kernels on one stream — delta (the row sum of P * dP), dQ,
    and dK/dV summed over each KV head's query heads inside one block —
    counted as one launch of the backward.
    """
    B, Hq, Hkv, Sq, Sk, D, Dv = _fa_check(q, k, v, kind, window, chunk,
                                          "flash_attention_bwd")
    if (out.shape != (B, Hq, Sq, Dv) or dout.shape != out.shape
            or lse.shape != (B, Hq, Sq)):
        raise ValueError(
            f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
            f"{tuple(lse.shape)} do not match q {tuple(q.shape)}, v {tuple(v.shape)}"
        )
    check_operands({"out": out, "dout": dout}, dtype=q.dtype, device=q.device)
    check_operands({"lse": lse}, dtype=torch.float32, device=q.device)
    scale = D ** -0.5 if scale is None else float(scale)
    _, bwd = _fa_launchers()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, D, Dv,
            DTYPE_CODES[q.dtype], FA_MASK_KINDS[kind], int(window), int(chunk),
            int(q_offset), scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "flash_attention")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.by_shape[kind, Sq, Sk] += 1
    return dq, dk, dv


#: launches of the forward / backward kernels since the last reset
flash_attention.launches = 0
flash_attention_bwd.launches = 0
#: the same launches by (mask kind, Sq, Sk), since the last ``clear()``
flash_attention.by_shape = collections.Counter()
flash_attention_bwd.by_shape = collections.Counter()



def smem_footprint_bytes(d: int, dv: int | None = None) -> dict[str, int]:
    """Dynamic shared memory, in bytes, of each bfloat16 kernel of
    ``csrc/flash_attention.cu`` for q/k head dim ``d`` and v head dim
    ``dv`` (default ``d``) — the port's counterpart of the reference's
    ``vmem_footprint_bytes``, and the number the C side exports as
    ``flash_attention_smem_bytes`` (and, for ``dv == d``,
    ``flash_attention_{fwd,bwd_dq,bwd_dkdv}_smem_bytes``).

    Every tile row is its width in bf16 padded by 16 bytes (Q, K rows
    ``d`` wide, V, dO rows ``dv``), and every kernel streams its tiles
    through a two-stage ring.  The forward keeps 128 query rows (64 past
    ``d`` = 128) and rings 64-key K and V tiles; the dQ kernel keeps 64
    rows each of Q and dO and rings 32-key K and V tiles; the dK/dV kernel
    keeps 64 rows each of K and V and rings 32-query Q and dO tiles with
    their f32 lse and delta rows.
    """
    dv = d if dv is None else dv
    if (d, dv) not in FA_HEAD_DIMS[torch.bfloat16]:
        raise ValueError(f"head dims ({d}, {dv}) not in {FA_HEAD_DIMS[torch.bfloat16]}")
    row, vrow, stages = (d + 8) * 2, (dv + 8) * 2, 2
    fwd_rows = 64 if d > 128 else 128
    return {
        "fwd": fwd_rows * row + stages * 64 * (row + vrow),
        "bwd_dq": (64 + stages * 32) * (row + vrow),
        "bwd_dkdv": (64 + stages * 32) * (row + vrow) + stages * 2 * 32 * 4,
    }


#: keys a tile of the bf16 prefill kernel, and the most rows a block holds
PREFILL_BK = 64
PREFILL_ROWS = 128
_INT_MAX = 2**31 - 1


def prefill_smem_bytes(d: int, sk: int) -> int:
    """Dynamic shared memory, in bytes, of the bf16 prefill kernel for head
    dim ``d`` and ``sk`` = Sc + Sn keys — the number the C side exports as
    ``prefill_attention_smem_bytes``.  128 padded Q rows, a two-stage ring
    of 64-key K and V tiles with their int32 positions, 80 bytes of the
    warps' position extremes, and 20 bytes a key tile (its min and max
    position, 64 valid bits, its entry in the list of reachable tiles)."""
    if d not in SUPPORTED_D:
        raise ValueError(f"head dim {d} not in {SUPPORTED_D}")
    row, stages = (d + 8) * 2, 2
    n_tiles = -(-sk // PREFILL_BK)
    return (PREFILL_ROWS * row + stages * 2 * PREFILL_BK * row
            + stages * PREFILL_BK * 4 + 80 + 20 * n_tiles)


def prefill_row_interval(qp: int, kind: str = "causal", window: int = 0,
                         chunk: int = 0) -> tuple[int, int]:
    """The key positions ``[lo, hi]`` a query at position ``qp`` reaches
    under the mask of :func:`repro_torch.kernels.ref.prefill_attention`:
    ``hi = qp`` and ``lo`` = 0 (causal), ``qp - window + 1`` (sliding) or
    the start of ``qp``'s chunk (chunked), at least 0 so holes
    (``k_pos < 0``) fall outside.  ``(2**31 - 1, -1)`` when it reaches
    nothing."""
    lo = 0
    if kind == "sliding":
        lo = qp - window + 1
    elif kind == "chunked":
        lo = (qp // chunk) * chunk
    elif kind != "causal":
        raise ValueError(f"prefill mask kind {kind!r}")
    lo = max(lo, 0)
    return (lo, qp) if 0 <= lo <= qp else (_INT_MAX, -1)


def prefill_tile_class(q_pos, k_pos, kind: str = "causal", window: int = 0,
                       chunk: int = 0, rows: range = range(16),
                       cols: range = range(PREFILL_BK)) -> str:
    """How the bf16 prefill kernel treats the query rows ``rows`` (a warp's
    16, or a block's) against the key columns ``cols`` (a tile) of one
    batch row with positions ``q_pos`` (Sq,) and ``k_pos`` (Sk,).  Rows
    past Sq and keys past Sk take part as the kernel sees them: reaching
    nothing, and invalid.

    ``"empty"``: no pair can be live (the warp skips the tile; for a
    block's rows, the tile is never loaded).  ``"full"``: every pair is
    live (no per-element test).  ``"partial"``: the exact test runs.  Only
    a provable verdict is empty or full."""
    qp = [int(x) for x in q_pos]
    kp = [int(x) for x in k_pos]
    iv = [prefill_row_interval(qp[i], kind, window, chunk) if i < len(qp)
          else (_INT_MAX, -1) for i in rows]
    keys = [kp[j] if j < len(kp) else -1 for j in cols]
    valid = [x for x in keys if x >= 0]
    k_min, k_max = min(valid, default=_INT_MAX), max(valid, default=-1)
    if k_min > max(h for _, h in iv) or k_max < min(lo for lo, _ in iv):
        return "empty"
    if (len(valid) == len(keys) and k_min >= max(lo for lo, _ in iv)
            and k_max <= min(h for _, h in iv)):
        return "full"
    return "partial"


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("prefill_attention")
        fn = lib.prefill_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 12 + [ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def flash_prefill(
    q: torch.Tensor,        # (B, Hq, Sq, D) chunk queries
    k: torch.Tensor,        # (B, Hkv, Sc, D) prior cache (first key source)
    v: torch.Tensor,        # (B, Hkv, Sc, D)
    q_pos: torch.Tensor,    # (B, Sq) int32 absolute query positions
    k_pos: torch.Tensor,    # (B, Sc + Sn) int32 key positions; < 0 = hole
    *,
    k_new: torch.Tensor | None = None,   # (B, Hkv, Sn, D) chunk keys
    v_new: torch.Tensor | None = None,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
    kv_head: int | None = None,
) -> torch.Tensor:
    """Launch the prefill kernel on ``q``'s device and current stream.

    Key index ``j < Sc`` is read from ``k``/``v`` and ``j >= Sc`` from
    ``k_new``/``v_new``; without a second source (``k_new=None``) this is
    the one-source function of the reference, with ``Sn = 0``.  With
    ``kv_head`` every query head attends head ``kv_head`` of both sources
    alone (a cache whose KV heads are replicated over a ``model`` axis),
    read in place: the plain version's ``k[:, kv_head:kv_head + 1]``.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_prefill takes float32 or bfloat16, got {q.dtype}")
    if kind not in MASK_KINDS:
        raise ValueError(f"prefill mask kind {kind!r}")
    if kind == "chunked" and chunk <= 0:
        raise ValueError("chunked mask needs chunk > 0")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    B, Hq, Sq, D = q.shape
    _, Hc, Sc, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if k_new is None:
        k_new, v_new, Sn = k, v, 0
    else:
        Sn = k_new.shape[2]
        if k_new.shape != (B, Hc, Sn, D) or v_new.shape != k_new.shape:
            raise ValueError(
                f"chunk keys {tuple(k_new.shape)} / values {tuple(v_new.shape)} "
                f"do not match (B, Hkv, Sn, D) = ({B}, {Hc}, Sn, {D})"
            )
    Hkv, off_c, off_n = Hc, 0, 0
    if kv_head is not None:
        if not 0 <= kv_head < Hc:
            raise ValueError(f"kv_head {kv_head} outside the cache's {Hc} heads")
        Hkv = 1
        off_c = kv_head * Sc * D * k.element_size()
        off_n = kv_head * Sn * D * k.element_size()
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not in {SUPPORTED_D}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sc + Sn):
        raise ValueError(
            f"q_pos {tuple(q_pos.shape)} / k_pos {tuple(k_pos.shape)}: want "
            f"({B}, {Sq}) / ({B}, {Sc + Sn})"
        )
    check_operands({"q": q, "k": k, "v": v, "k_new": k_new, "v_new": v_new},
                   dtype=q.dtype, device=q.device)
    check_operands({"q_pos": q_pos, "k_pos": k_pos},
                   dtype=torch.int32, device=q.device)
    if q.dtype == torch.bfloat16 and prefill_smem_bytes(D, Sc + Sn) > SMEM_BUDGET:
        raise ValueError(f"{Sc + Sn} keys: the bf16 kernel's tile list does not "
                         f"fit {SMEM_BUDGET} bytes of shared memory")
    scale = D ** -0.5 if scale is None else float(scale)

    fn = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = fn(
            q.data_ptr(), k.data_ptr() + off_c, v.data_ptr() + off_c,
            k_new.data_ptr() + off_n, v_new.data_ptr() + off_n,
            q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Hc, Sq, Sc, Sn, D, DTYPE_CODES[q.dtype],
            MASK_KINDS[kind], int(window), int(chunk), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "prefill_attention")
    flash_prefill.launches += 1
    return out


#: launches of the prefill kernel since the last reset
flash_prefill.launches = 0
