"""Single-token GQA decode attention: the CUDA kernel and its wrapper.

Counterpart of ``repro/kernels/decode_attention.py`` (``flash_decode``).
The kernel lives in ``repro_torch/csrc/decode_attention.cu``; it is built
with ``nvcc`` on first use.  The plain version of the same function is
:func:`repro_torch.kernels.ref.decode_attention`.

What bounds it: bytes — each live key and value of a (row, KV head) is
read once for its G query heads, about G flops a byte.  So the kernel
spreads each row's live keys over ``num_splits`` blocks that form one
thread-block cluster, streams K/V tiles through a ``cp.async`` ring into
tensor-core products (bf16), and combines the splits through distributed
shared memory in the same launch.  The host's only work per call is the
output's allocation and the launch: the split count comes from the SM
count, read once per device, and no scratch or counter outlives a call,
so the launch can be captured in a CUDA graph.

``kv_head`` serves a cache whose KV heads are replicated over a ``model``
axis: every query head of the call attends that one head of each row,
which the kernel reads in place (the cache's row stride is an argument),
so the head slice, not contiguous when B > 1, is never copied.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_D = (16, 32, 64, 128)
MAX_GROUP = 16          # largest Hq / Hkv the kernel's query tile holds
MAX_SPLITS = 8          # blocks per (row, KV head): the portable cluster size
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: keys per tile, the unit in which a row's live keys are split
KEY_TILE = {torch.float32: 32, torch.bfloat16: 64}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        launch = _build.load("decode_attention").decode_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        launch.argtypes = [P] * 5 + [I] * 8 + [ctypes.c_float, P]
        launch.restype = I
        _fn = launch
    return _fn


def num_splits(B: int, Hkv: int, Smax: int, key_tile: int, sms: int) -> int:
    """Blocks per (row, KV head): enough for two blocks per SM over the
    B·Hkv rows, at most one key tile each, at most ``MAX_SPLITS``."""
    ns = -(-2 * sms // max(B * Hkv, 1))
    return max(1, min(ns, MAX_SPLITS, -(-Smax // key_tile)))


def split_ranges(length: int, Smax: int, ns: int, key_tile: int) -> list[tuple[int, int]]:
    """The live keys [lo, hi) each of the ``ns`` splits of a row reads: the
    row's tiles cut into ``ns`` near-equal runs, ending at the length
    clamped to [0, Smax].  Mirrors ``split_tiles`` in the kernel."""
    L = min(max(int(length), 0), Smax)
    nt = -(-L // key_tile)
    return [(min(s * nt // ns * key_tile, L), min((s + 1) * nt // ns * key_tile, L))
            for s in range(ns)]


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of the bf16 kernel at head dim D: 16 query
    rows and a 2-stage ring of 64-key K and V tiles, rows of D bf16 padded
    by 16 bytes (``DecSmem`` in the source)."""
    row = 2 * D + 16
    return 16 * row + 2 * 2 * KEY_TILE[torch.bfloat16] * row


def check_operands(tensors: dict, *, dtype, device) -> None:
    """Raise on anything the CUDA kernels do not take: device, dtype,
    contiguity, 16-byte alignment (the kernels load 16 bytes a thread)."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_decode(
    q: torch.Tensor,        # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hkv, Smax, D)
    v_cache: torch.Tensor,  # (B, Hkv, Smax, D)
    lengths: torch.Tensor,  # (B,) int32 valid entries per row
    *,
    scale: float | None = None,
    kv_head: int | None = None,
) -> torch.Tensor:
    """Launch the decode kernel on ``q``'s device and current stream.
    ``lengths`` is clamped to [0, Smax]; a row of length 0 comes out 0.
    With ``kv_head`` every query head attends head ``kv_head`` of the
    cache alone, read in place: the plain version's
    ``k_cache[:, kv_head:kv_head + 1]``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}: want (B,Hq,D), (B,Hkv,Smax,D) x2"
        )
    B, Hq, D = q.shape
    _, Hc, Smax, _ = k_cache.shape
    Hkv, offset = Hc, 0
    if kv_head is not None:
        if not 0 <= kv_head < Hc:
            raise ValueError(f"kv_head {kv_head} outside the cache's {Hc} heads")
        Hkv, offset = 1, kv_head * Smax * D * k_cache.element_size()
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not in {SUPPORTED_D}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq}, Hkv={Hkv}: need Hkv | Hq and Hq/Hkv <= {MAX_GROUP}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be a (B,) int32 tensor")
    check_operands({"q": q, "k_cache": k_cache, "v_cache": v_cache},
                   dtype=q.dtype, device=q.device)
    check_operands({"lengths": lengths}, dtype=torch.int32, device=q.device)
    scale = D ** -0.5 if scale is None else float(scale)

    launch = _launcher()
    out = torch.empty_like(q)
    ns = num_splits(B, Hkv, Smax, KEY_TILE[q.dtype], _build.sm_count(q.device))
    with torch.cuda.device(q.device):
        status = launch(
            q.data_ptr(), k_cache.data_ptr() + offset, v_cache.data_ptr() + offset,
            lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, Hc, Smax, D, ns,
            DTYPE_CODES[q.dtype], scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(status, "decode_attention")
    flash_decode.launches += 1
    return out


#: launches of the decode kernel since the last reset
flash_decode.launches = 0
