"""Mamba-2 chunked SSD scan: the CUDA kernel and its wrapper.

Counterpart of ``repro/kernels/ssd_scan.py`` (``ssd_scan``).  The kernel
lives in ``repro_torch/csrc/ssd_scan.cu``; it is built with ``nvcc`` on
first use.  Unlike the Pallas kernel it takes an initial state and returns
the final one, so it carries serving prefill as well.  The plain version
of the same function is :func:`repro_torch.kernels.ref.ssd_scan`.  Its
backward (:func:`ssd_scan_bwd`, ``csrc/ssd_scan_bwd.cu``) stands where the
reference's ``custom_vjp`` recomputes through its oracle; its plain
version is :func:`repro_torch.kernels.ref.ssd_scan_bwd`.  In bf16 it too
runs its products on the tensor cores, in chunks of :data:`BWD_CHUNK`.

What bounds it: bytes at the serving shape, once its products run on the
tensor cores (as f32 FMAs they would take ~5x longer than the bytes).  In
bf16 a block carries :func:`heads_per_block` heads of one row: B and C
are loaded and C·Bᵀ computed once per chunk for all of them, the f32 state
stays in the warps' accumulators for the whole launch, and every f32
operand of a product (the state, the decay matrix, x·dt·decay) goes in as
a bf16 hi + lo pair, so the result keeps f32 accuracy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_P = (32, 64)
SUPPORTED_N = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WARPS = 12          # a bf16 block: heads_per_block x P / 16 warps

_fn = None
_bwd_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn = lib.ssd_scan_launch
        fn.argtypes = ([P, L, L, L, P, L, L, L, P, P, L, L, P, L, L, P, P, P]
                       + [I] * 7 + [P])
        fn.restype = I
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.load("ssd_scan_bwd")
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn = lib.ssd_scan_bwd_launch
        fn.argtypes = ([P, L, L, L, P, L, L, L, P, P, L, L, P, L, L, P, L, L, L]
                       + [P] * 10 + [I] * 6 + [P])
        fn.restype = I
        _bwd_fn = fn
    return _bwd_fn


def heads_per_block(B: int, H: int, P: int, sms: int) -> int:
    """Heads one block of the bf16 kernel carries: the fewest (each block
    shares its chunk's B, C and C·Bᵀ among them) for which the grid of
    B x ceil(H / hb) blocks fits the SMs in one wave, at most
    ``MAX_WARPS / (P / 16)`` (one warp per 16 state rows) and at most H.
    At the mamba2-780m serving shape (B 8, H 48, P 64, 132 SMs): 3, 128
    blocks."""
    hb_max = min(MAX_WARPS // (P // 16), H)
    for hb in range(1, hb_max + 1):
        if B * -(-H // hb) <= sms:
            return hb
    return max(hb_max, 1)


def smem_bytes(P: int, N: int, hb: int) -> int:
    """Dynamic shared memory of the bf16 kernel with ``hb`` heads a block:
    two stages of a 32-position chunk's C and B rows, hb heads' x rows and
    dt, then each head's 32 x 32 decay matrix as a bf16 hi and lo pair and
    the f32 C·Bᵀ (rows of 40); bf16 rows padded by 16 bytes (``ScanSmem``
    in the source)."""
    q = 32
    stage = 2 * q * (2 * N + 16) + hb * q * (2 * P + 16) + hb * q * 4
    return 2 * stage + hb * 2 * q * (2 * q + 16) + q * (q + 8) * 4


#: positions a chunk of the backward's bf16 kernels (the tensor-core route)
BWD_CHUNK = 64
#: positions a chunk of its f32 kernels (f32 FMAs, one lane a position)
BWD_CHUNK_F32 = 32


def bwd_chunk(dtype: torch.dtype) -> int:
    """Positions a chunk of the backward kernels for ``dtype``."""
    return BWD_CHUNK if dtype == torch.bfloat16 else BWD_CHUNK_F32


def bwd_scratch_bytes(B: int, T: int, H: int, P: int, N: int, dtype: torch.dtype) -> int:
    """Bytes of the backward's scratch, the chunk start states and end-state
    gradients (B, H, ceil(T / chunk), P, N) each: bf16 in the tensor-core
    route, f32 in the FMA route.  Written once and read once a call."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return 2 * B * H * -(-T // bwd_chunk(dtype)) * P * N * itemsize


def smem_bytes_bwd(P: int, N: int, kernel: int) -> int:
    """Dynamic shared memory of the backward's kernels (``StateSmem``,
    ``ChunkSmem``, ``StateMma``, ``ChunkMma`` in the source):

    * 0, the f32 state pass: the transposed x·dt or dy rows, B or C rows,
      the state, two decay vectors; 1, the f32 chunk pass: B, C, x and dy
      rows, h_s and G_e, four 32 x 32 tiles, four vectors, the per-row
      partials of dy·h_s C, x·g B and x·G_e B, one float a warp; all f32,
      rows padded by 4 floats;
    * 2, the bf16 state pass: three stages of a 64-position chunk's x or
      dy rows, B or C rows and dt, then each warp's 16 staged rows of its
      slice of the state; 3, the bf16 chunk pass: B and C rows, two stages
      of a head's x and dy rows, h_s, G_e and dt, the three 64 x 64 tiles
      M, W, W·dt, two sets of 13 x 64 + 16 per-position floats, and each
      of its 8 warps' 16 staged rows of dx (P / 2 wide); bf16 rows padded
      by 16 bytes.
    """
    if kernel in (0, 1):
        q, qs, ns, ps = BWD_CHUNK_F32, BWD_CHUNK_F32 + 4, N + 4, P + 4
        if kernel == 0:
            return 4 * (P * qs + q * ns + P * ns + 2 * q)
        return 4 * (2 * q * ns + 2 * q * ps + 2 * P * ns + 4 * q * qs + 4 * q
                    + q * (N // 4) + 2 * q * (P // 32) + 256 // 32)
    q, rn, rp, rq = BWD_CHUNK, 2 * N + 16, 2 * P + 16, 2 * BWD_CHUNK + 16
    if kernel == 2:
        rows, cols = P // 16, min(8 // (P // 16), N // 16)   # warps down and across
        return 3 * (q * rp + q * rn + 4 * q) + rows * cols * 16 * (2 * (N // cols) + 16)
    stage = 2 * q * rp + 2 * P * rn + 4 * q
    return (2 * q * rn + 2 * stage + 3 * q * rq + 2 * 4 * (13 * q + 16)
            + 8 * 16 * (P + 16))


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if every row (last dim) starts 16-byte aligned, as the bf16
    kernel's cp.async copies need; else a contiguous copy, which does."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_state(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 tensor on {device}, got "
                        f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, got "
                         f"{tuple(t.shape)}")


def _check_inputs(x, dt, A, Bmat, Cmat):
    """(B, T, H, P, N) of the scan's inputs; raises for what the kernels
    do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, T, H, P), got {tuple(x.shape)}")
    Bsz, T, H, P = x.shape
    N = Bmat.shape[-1]
    if P not in SUPPORTED_P or N not in SUPPORTED_N:
        raise ValueError(f"head dim P={P} / state N={N} not in "
                         f"{SUPPORTED_P} / {SUPPORTED_N}")
    if tuple(dt.shape) != (Bsz, T, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    for name, t in (("Bmat", Bmat), ("Cmat", Cmat)):
        if tuple(t.shape) != (Bsz, T, N):
            raise ValueError(f"{name} must be {(Bsz, T, N)}, got {tuple(t.shape)}")
    for name, t, dtype in (("dt", dt, torch.float32), ("A", A, torch.float32),
                           ("Bmat", Bmat, x.dtype), ("Cmat", Cmat, x.dtype)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if x.stride(3) != 1 or Bmat.stride(2) != 1 or Cmat.stride(2) != 1:
        raise ValueError("the last dim of x, Bmat and Cmat must be contiguous")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    return Bsz, T, H, P, N


def ssd_scan(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) float32
    A: torch.Tensor,      # (H,) float32
    Bmat: torch.Tensor,   # (B, T, N)
    Cmat: torch.Tensor,   # (B, T, N)
    *,
    init_state: torch.Tensor | None = None,   # (B, H, P, N) float32
    return_state: bool = False,
    chunk: int | None = None,
    state_out: torch.Tensor | None = None,
):
    """Launch the SSD kernel on ``x``'s device and current stream.

    Returns ``y`` (B, T, H, P) in x's dtype, and with ``return_state`` the
    final state (B, H, P, N) float32 as well.  ``state_out`` (with
    ``return_state``) is the buffer the final state is written to; it may
    be ``init_state`` itself — the kernel reads each (row, head) slice of
    the initial state whole before it writes that slice.

    ``chunk`` is accepted for the reference's signature and not used: the
    kernel walks its own chunks of 32 positions (the intra-chunk work grows
    with the chunk, the state work does not), and its result equals the
    chunked oracle's at any chunk up to f32 rounding (each f32 operand of a
    tensor-core product goes in as a bf16 hi + lo pair).
    T may be anything (no ``T % chunk`` requirement).  x, B and C may be
    strided views (the model passes slices of the conv output); their last
    dim must be contiguous, and in bf16 a view whose rows do not start
    16-byte aligned is copied first.
    """
    Bsz, T, H, P, N = _check_inputs(x, dt, A, Bmat, Cmat)
    if state_out is not None and not return_state:
        raise ValueError("state_out needs return_state=True")
    shape = (Bsz, H, P, N)
    if init_state is not None:
        _check_state("init_state", init_state, shape, x.device)
    if return_state:
        if state_out is None:
            state_out = torch.empty(shape, dtype=torch.float32, device=x.device)
        _check_state("state_out", state_out, shape, x.device)

    hb = 1
    if x.dtype == torch.bfloat16:
        x, Bmat, Cmat = _aligned_rows(x), _aligned_rows(Bmat), _aligned_rows(Cmat)
        hb = heads_per_block(Bsz, H, P, _build.sm_count(x.device))
    for name, t in (("init_state", init_state), ("state_out", state_out)):
        if t is not None and t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")

    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _launcher()(
            x.data_ptr(), *x.stride()[:3],
            dt.data_ptr(), *dt.stride(),
            A.data_ptr(),
            Bmat.data_ptr(), *Bmat.stride()[:2],
            Cmat.data_ptr(), *Cmat.stride()[:2],
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            Bsz, T, H, P, N, DTYPE_CODES[x.dtype], hb,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "ssd_scan")
    ssd_scan.launches += 1
    return (y, state_out) if return_state else y


#: launches of the SSD kernel since the last reset
ssd_scan.launches = 0


def ssd_scan_bwd(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) float32
    A: torch.Tensor,      # (H,) float32
    Bmat: torch.Tensor,   # (B, T, N)
    Cmat: torch.Tensor,   # (B, T, N)
    dy: torch.Tensor,     # (B, T, H, P), x's dtype
    *,
    init_state: torch.Tensor | None = None,    # (B, H, P, N) float32
    d_state_out: torch.Tensor | None = None,   # (B, H, P, N) float32
    chunk: int | None = None,
):
    """Launch the SSD scan's backward on ``x``'s device and current stream.

    ``dy`` is the gradient of ``y``, ``d_state_out`` (optional) that of the
    final state.  Returns ``(dx, ddt, dA, dB, dC, d_init_state)``: dx, dB
    and dC in x's dtype, ddt, dA and d_init_state in float32, each shaped
    like its input (``d_init_state`` is None without ``init_state``).  The
    inputs may be the strided views the forward takes (last dim
    contiguous; in bf16 a view whose rows do not start 16-byte aligned is
    copied first); ``chunk`` is accepted for the reference's signature and
    not used (the kernels walk chunks of :func:`bwd_chunk` positions).

    Two kernels.  A state pass writes every chunk's start state and
    end-state gradient into scratch of (B, H, ceil(T / chunk), P, N) each:
    in bf16 the forward and backward walks run as separate blocks on the
    tensor cores, chunks of :data:`BWD_CHUNK` = 64, the scratch rounded to
    bf16 (``tests/test_torch_ssd_bwd_rounding.py`` emulates which f32
    operands take one rounding); in f32 one block walks both, chunks of
    32, f32 scratch.  Then a chunk pass, one block per (chunk, row),
    writes every head's dx and ddt and sums dB and dC over the heads in
    the block.  dA comes out as one partial a (row, chunk, head), summed
    here with ``torch.sum``.
    """
    Bsz, T, H, P, N = _check_inputs(x, dt, A, Bmat, Cmat)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be a {x.dtype} {tuple(x.shape)} tensor on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    if x.dtype == torch.bfloat16:
        x, Bmat, Cmat, dy = (_aligned_rows(t) for t in (x, Bmat, Cmat, dy))
    shape = (Bsz, H, P, N)
    if init_state is not None:
        _check_state("init_state", init_state, shape, x.device)
    if d_state_out is not None:
        _check_state("d_state_out", d_state_out, shape, x.device)

    nc = -(-T // bwd_chunk(x.dtype))
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = dict(dtype=torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32,
                   device=x.device)
    S = torch.empty((Bsz, H, nc, P, N), **scratch)
    G = torch.empty((Bsz, H, nc, P, N), **scratch)
    dx = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, T, H), **f32)
    dB = torch.empty((Bsz, T, N), dtype=x.dtype, device=x.device)
    dC = torch.empty((Bsz, T, N), dtype=x.dtype, device=x.device)
    dA_part = torch.empty((Bsz, nc, H), **f32)
    d_init = None if init_state is None else torch.empty(shape, **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        status = _bwd_launcher()(
            x.data_ptr(), *x.stride()[:3],
            dt.data_ptr(), *dt.stride(),
            A.data_ptr(),
            Bmat.data_ptr(), *Bmat.stride()[:2],
            Cmat.data_ptr(), *Cmat.stride()[:2],
            dy.data_ptr(), *dy.stride()[:3],
            ptr(init_state), ptr(d_state_out), S.data_ptr(), G.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            ptr(d_init), dA_part.data_ptr(),
            Bsz, T, H, P, N, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA_part.sum((0, 1)), dB, dC, d_init


#: launches of the SSD backward (its two kernels) since the last reset
ssd_scan_bwd.launches = 0
