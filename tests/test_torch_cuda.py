"""The port's CUDA kernels and its card path, held to the plain versions.

These tests need an NVIDIA card and ``nvcc``; without a card each skips
with its reason.  Run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none): the plain PyTorch
versions it compares with are held to the JAX reference on the CPU by
``tests/test_torch_kernels.py`` and ``tests/test_torch_model.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import blocked_matmul as bmm
from repro_torch.kernels import membench, ops, ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_prefill,
)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map


@pytest.fixture
def cuda_only():
    """Decides at run time, never at import: skip unless a card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


#: the marker for tests that run only on the card
requires_cuda = pytest.mark.usefixtures("cuda_only")

#: bf16 limits sit near the outputs' scale (row RMS ~ 1/sqrt(live keys),
#: 0.03-0.2 here), well above a one-ulp rounding difference
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
       torch.float32: dict(atol=3e-5, rtol=1e-5)}


def _randn(*shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,Smax,lengths", [
    (3, 8, 1, 16, 64, [1, 17, 64]),
    (2, 16, 16, 128, 300, [299, 1]),
    (2, 32, 4, 128, 1000, [1000, 513]),
])
def test_decode_kernel_matches_plain(B, Hq, Hkv, D, Smax, lengths, dtype):
    q = _randn(B, Hq, D, dtype=dtype, seed=0)
    k = _randn(B, Hkv, Smax, D, dtype=dtype, seed=1)
    v = _randn(B, Hkv, Smax, D, dtype=dtype, seed=2)
    L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    got = ops.decode_attention(q, k, v, L)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, L).float(),
                               **TOL[dtype])


def _decode_matches_plain(B, Hq, Hkv, D, Smax, lengths, dtype, seed=50):
    """flash_decode (one launch) against ref.decode_attention at TOL on the
    rows with a live key; a row whose clamped length is 0 comes out 0, as
    the Pallas kernel's does (the plain version gives mean(V) there)."""
    q = _randn(B, Hq, D, dtype=dtype, seed=seed)
    k = _randn(B, Hkv, Smax, D, dtype=dtype, seed=seed + 1)
    v = _randn(B, Hkv, Smax, D, dtype=dtype, seed=seed + 2)
    L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    got = flash_decode(q, k, v, L)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    live = L > 0
    want = ref.decode_attention(q, k, v, L.clamp(0, Smax))
    torch.testing.assert_close(got.float()[live], want.float()[live], **TOL[dtype])
    assert torch.all(got[~live] == 0)
    return q, k, v, L, got


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_yi_shape_length_edges(dtype):
    """yi-6b's phase 5 shape (8 rows, 32/4 heads, D 128, Smax 2048) with
    lengths below 0 and 0 (clamped: no key), 1, one tile less, at and past
    one 64-key tile, Smax, and past Smax (clamped to Smax)."""
    _decode_matches_plain(8, 32, 4, 128, 2048, [-3, 0, 1, 63, 64, 65, 2048, 5000], dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv", [(32, 2), (8, 8)])
def test_decode_kernel_group_sizes(Hq, Hkv, dtype):
    """G = 16 (MAX_GROUP: the whole 16-row query tile) and G = 1 (15 zero
    rows) at D = 128, lengths across the split edges."""
    _decode_matches_plain(4, Hq, Hkv, 128, 1500, [1500, 777, 129, 5], dtype, seed=60)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_every_row_length_one(dtype):
    """Every split but the first of every row is empty."""
    _decode_matches_plain(8, 32, 4, 128, 2048, [1] * 8, dtype, seed=70)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_deterministic(dtype):
    """The splits are combined in a fixed order with no atomics and no
    state left between calls: two calls in a row are bit-identical."""
    q, k, v, L, first = _decode_matches_plain(8, 32, 4, 128, 2048,
                                              [650, 2048, 1, 900, 64, 65, 1300, 333], dtype)
    second = flash_decode(q, k, v, L)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@requires_cuda
def test_decode_kernel_replays_in_a_cuda_graph():
    """A call captured in a CUDA graph and replayed after the lengths (and
    the query) change in place gives the eager call's result bit for bit:
    the wrapper makes no host query that the replay would see stale."""
    dt = torch.bfloat16
    q = _randn(8, 32, 128, dtype=dt, seed=80)
    k = _randn(8, 4, 2048, 128, dtype=dt, seed=81)
    v = _randn(8, 4, 2048, 128, dtype=dt, seed=82)
    L = torch.tensor([100, 2048, 1, 900, 64, 65, 1300, 333], dtype=torch.int32,
                     device="cuda")
    flash_decode(q, k, v, L)                       # build and warm up eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, L)
    L.copy_(torch.tensor([1999, 3, 0, 640, 65, 64, 1, 2048], dtype=torch.int32))
    q.copy_(_randn(8, 32, 128, dtype=dt, seed=83))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, flash_decode(q, k, v, L))
    live = L > 0
    want = ref.decode_attention(q, k, v, L)
    torch.testing.assert_close(out.float()[live], want.float()[live], **TOL[dt])


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,kw", [("causal", {}), ("sliding", {"window": 20}),
                                     ("chunked", {"chunk": 24})])
def test_prefill_kernel_matches_plain(kind, kw, dtype):
    B, Hq, Hkv, D, Sc, Sn = 3, 8, 2, 64, 90, 12
    q = _randn(B, Hq, Sn, D, dtype=dtype, seed=3)
    kc, vc = (_randn(B, Hkv, Sc, D, dtype=dtype, seed=s) for s in (4, 5))
    kn, vn = (_randn(B, Hkv, Sn, D, dtype=dtype, seed=s) for s in (6, 7))
    offs = torch.tensor([[0], [40], [78]], dtype=torch.int32, device="cuda")
    nl = torch.tensor([[12], [5], [0]], dtype=torch.int32, device="cuda")
    j = torch.arange(Sn, dtype=torch.int32, device="cuda")[None]
    r = torch.arange(Sc, dtype=torch.int32, device="cuda")[None]
    q_pos = (offs + j).contiguous()
    k_pos = torch.cat([torch.where(r < offs, r, -1),
                       torch.where(j < nl, q_pos, -1)], 1).contiguous()
    before = flash_prefill.launches
    got = ops.prefill_attention(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn,
                                kind=kind, **kw)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = ref.prefill_attention(q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2),
                                 q_pos, k_pos, kind=kind, **kw)
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    live = ((qp >= kp) & (kp >= 0))
    if kind == "sliding":
        live &= (qp - kp) < kw["window"]
    elif kind == "chunked":
        live &= (qp // kw["chunk"]) == (kp // kw["chunk"])
    rows = live.any(-1)[:, None, :].expand(B, Hq, Sn)     # padding rows differ
    torch.testing.assert_close(got.float()[rows], want.float()[rows], **TOL[dtype])


def _pf_positions(B, Sq, Sc, Sn, layout, seed, hole_rate=0.0):
    """q_pos (B, Sq) and k_pos (B, Sc + Sn) on the card, from numpy: each
    row's chunk of Sq queries at a cache fill, the chunk's first new_len
    keys live; ``layout`` "ordered" (slot r holds position r below the
    fill), "ring" (a ring of Sc slots past its first wrap, as
    ``_ring_positions`` gives it), with holes punched at ``hole_rate``."""
    from repro_torch.models.attention import _ring_positions

    rng = np.random.default_rng(seed)
    if layout == "ring":
        offs = rng.integers(Sc + 1, 4 * Sc + 2, B)
        cache = _ring_positions(torch.tensor(offs, dtype=torch.int32), Sc).numpy()
    else:
        offs = rng.integers(0, Sc + 1, B)
        offs[0] = Sc                                  # a full cache
        r = np.arange(Sc)[None]
        cache = np.where(r < offs[:, None], r, -1)
    q_pos = offs[:, None] + np.arange(Sq)[None]
    new_len = rng.integers(0, Sn + 1, B)
    new = np.where(np.arange(Sn)[None] < new_len[:, None],
                   offs[:, None] + np.arange(Sn)[None], -1)
    k_pos = np.concatenate([cache, new], 1)
    if hole_rate:
        k_pos[:, :Sc][rng.random((B, Sc)) < hole_rate] = -1
    as_t = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda").contiguous()
    return as_t(q_pos), as_t(k_pos)


def _bf16_prefill_matches_plain(B, G, Hkv, D, Sq, Sc, Sn, layout="ordered", kind="causal",
                                kw=None, hole_rate=0.0, positions=None, seed=40):
    """flash_prefill in bf16 (one launch) against ref.prefill_attention over
    the concatenated sources at TOL; rows with no live key are exactly 0.
    Sn = 0 is the one-source call."""
    kw = kw or {}
    dt = torch.bfloat16
    q = _randn(B, G * Hkv, Sq, D, dtype=dt, seed=seed)
    kc, vc = (_randn(B, Hkv, Sc, D, dtype=dt, seed=seed + s) for s in (1, 2))
    kn, vn = (_randn(B, Hkv, Sn, D, dtype=dt, seed=seed + s) for s in (3, 4))
    q_pos, k_pos = positions or _pf_positions(B, Sq, Sc, Sn, layout, seed, hole_rate)
    extra = dict(k_new=kn, v_new=vn) if Sn else {}
    before = flash_prefill.launches
    got = flash_prefill(q, kc, vc, q_pos, k_pos, kind=kind, **extra, **kw)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    k, v = torch.cat([kc, kn], 2), torch.cat([vc, vn], 2)
    want = ref.prefill_attention(q, k, v, q_pos, k_pos, kind=kind, **kw)
    rows = ref.prefill_mask(q_pos, k_pos, kind=kind, **kw).any(-1)     # (B, Sq)
    rows = rows[:, None, :].expand(B, G * Hkv, Sq)
    torch.testing.assert_close(got.float()[rows], want.float()[rows], **TOL[dt])
    assert torch.all(got[~rows] == 0)
    return got


@requires_cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 8, 16])
def test_prefill_bf16_gqa_and_head_dims(G, D):
    """Every head dim at G = 1 (a block of 128 queries of one head), 2, 8
    (yi-6b: 16 queries of 8 heads share each K/V tile) and 16 (two blocks of
    8 heads), with holes in the cache."""
    _bf16_prefill_matches_plain(3, G, 2, D, 40, 200, 40, hole_rate=0.05)


@requires_cuda
@pytest.mark.parametrize("Sq,Sn", [(1, 1), (17, 17), (129, 129), (17, 0), (129, 0), (33, 7)])
def test_prefill_bf16_lengths_off_the_tile(Sq, Sn):
    """Query and chunk lengths off the 16-row and 64-key tiles; Sn = 0 is
    the one-source call, Sq != Sn a chunk whose keys are not its queries."""
    _bf16_prefill_matches_plain(2, 8, 2, 128, Sq, 150, Sn)


@requires_cuda
@pytest.mark.parametrize("layout,Sc,hole_rate", [
    ("ring", 96, 0.0),      # positions wrap: not in order along the cache
    ("ring", 130, 0.1),     # and with holes
    ("ordered", 100, 0.0),  # a key tile straddles Sc: rows from both sources
    ("ordered", 256, 0.02), # holes inside tiles that would otherwise be full
])
def test_prefill_bf16_ring_holes_and_straddle(layout, Sc, hole_rate):
    _bf16_prefill_matches_plain(4, 4, 2, 64, 48, Sc, 48, layout, hole_rate=hole_rate)


@requires_cuda
@pytest.mark.parametrize("kind,kw", [
    ("sliding", {"window": 20}), ("sliding", {"window": 300}), ("sliding", {"window": 1}),
    ("chunked", {"chunk": 24}), ("chunked", {"chunk": 64}), ("chunked", {"chunk": 1000}),
])
@pytest.mark.parametrize("layout", ["ordered", "ring"])
def test_prefill_bf16_masks(kind, kw, layout):
    _bf16_prefill_matches_plain(3, 4, 2, 64, 70, 200, 70, layout, kind, kw, hole_rate=0.03)


@requires_cuda
def test_prefill_bf16_dead_rows_are_zero():
    """Rows with no live key come out 0: a query at position -1, a batch row
    whose keys are all holes, and queries earlier than every key."""
    B, Sq, Sc, Sn = 3, 20, 64, 20
    q_pos = torch.arange(Sq, dtype=torch.int32, device="cuda")[None].repeat(B, 1) + 100
    k_pos = torch.arange(Sc + Sn, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    q_pos[0, :5] = -1
    k_pos[1] = -1
    k_pos[2] += 110                # queries 100-109 precede every key
    got = _bf16_prefill_matches_plain(B, 8, 1, 32, Sq, Sc, Sn,
                                      positions=(q_pos.contiguous(), k_pos.contiguous()))
    assert torch.all(got[0, :, :5] == 0) and torch.all(got[1] == 0)
    assert torch.all(got[2, :, :10] == 0) and torch.any(got[2, :, 10:] != 0)


@requires_cuda
def test_prefill_bf16_one_source_equals_two():
    """The same keys read from one source or split at Sc: bit for bit."""
    dt = torch.bfloat16
    q = _randn(2, 16, 60, 128, dtype=dt, seed=50)
    k, v = (_randn(2, 2, 190, 128, dtype=dt, seed=s) for s in (51, 52))
    q_pos, k_pos = _pf_positions(2, 60, 130, 60, "ordered", 53)
    one = flash_prefill(q, k, v, q_pos, k_pos)
    two = flash_prefill(q, k[:, :, :130].contiguous(), v[:, :, :130].contiguous(), q_pos,
                        k_pos, k_new=k[:, :, 130:].contiguous(),
                        v_new=v[:, :, 130:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@requires_cuda
def test_prefill_smem_bytes_match_the_kernel():
    """prefill_smem_bytes is what the bf16 kernel launches with; a key count
    whose tile list does not fit is refused before any launch."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import SUPPORTED_D
    from repro_torch.kernels.flash_attention import prefill_smem_bytes

    fn = _build.load("prefill_attention").prefill_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for d in SUPPORTED_D:
        for sk in (1, 64, 65, 2304, 40000):
            assert fn(d, sk) == prefill_smem_bytes(d, sk), (d, sk)
    assert fn(48, 64) == 0
    x = torch.zeros(1, 1, 1, 128, device="cuda", dtype=torch.bfloat16)
    sk = 64 * 8000
    kv = torch.zeros(1, 1, sk, 128, device="cuda", dtype=torch.bfloat16)
    before = flash_prefill.launches
    with pytest.raises(ValueError, match="tile list"):
        flash_prefill(x, kv, kv, torch.zeros(1, 1, dtype=torch.int32, device="cuda"),
                      torch.zeros(1, sk, dtype=torch.int32, device="cuda"))
    assert flash_prefill.launches == before


def _live_rows(kind, kw, Sq, Sk, q_offset):
    qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    if kind == "bidirectional":
        return torch.ones(Sq, dtype=torch.bool, device="cuda")
    live = qp >= kp
    if kind == "sliding":
        live &= (qp - kp) < kw["window"]
    elif kind == "chunked":
        live &= (qp // kw["chunk"]) == (kp // kw["chunk"])
    return live.any(-1)


#: gradients: f32 sums over up to Sk terms in another order; bf16 grads
#: are rounded once more than the plain version's f32 ones
GRAD_TOL = {torch.bfloat16: dict(atol=3e-2, rtol=3e-2),
            torch.float32: dict(atol=1e-4, rtol=1e-4)}


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,q_offset,kind,kw", [
    (2, 4, 4, 128, 128, 128, 0, "causal", {}),
    (1, 8, 2, 100, 100, 64, 0, "causal", {}),
    (2, 8, 1, 77, 77, 16, 0, "causal", {}),
    (1, 4, 2, 96, 160, 32, 64, "sliding", {"window": 40}),
    (1, 4, 2, 96, 160, 32, 64, "chunked", {"chunk": 48}),
    (1, 4, 2, 50, 90, 64, 7, "bidirectional", {}),
])
def test_flash_attention_fwd_bwd_match_plain(B, Hq, Hkv, Sq, Sk, D, q_offset,
                                             kind, kw, dtype):
    _attention_matches_plain(B, Hq, Hkv, Sq, Sk, D, q_offset, kind, kw, dtype)


def _attention_matches_plain(B, Hq, Hkv, Sq, Sk, D, q_offset, kind, kw, dtype, seed=8):
    """ops.attention's kernels, forward and backward (one launch each),
    against ref.attention and autograd through it, at TOL / GRAD_TOL.  Rows
    without a live key carry no cotangent and must come out 0 (the plain
    version gives the mean of V there)."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
    q = _randn(B, Hq, Sq, D, dtype=dtype, seed=seed).requires_grad_()
    k = _randn(B, Hkv, Sk, D, dtype=dtype, seed=seed + 1).requires_grad_()
    v = _randn(B, Hkv, Sk, D, dtype=dtype, seed=seed + 2).requires_grad_()
    dout = _randn(B, Hq, Sq, D, dtype=dtype, seed=seed + 3)
    rows = _live_rows(kind, kw, Sq, Sk, q_offset)
    dout = dout * rows[:, None].to(dtype)      # padding rows carry no gradient
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    got = ops.attention(q, k, v, kind=kind, q_offset=q_offset, **kw)
    g_got = torch.autograd.grad(got, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    want = ref.attention(q, k, v, kind=kind, q_offset=q_offset, **kw)
    g_want = torch.autograd.grad(want, (q, k, v), dout)
    torch.testing.assert_close(got.float()[:, :, rows], want.float()[:, :, rows],
                               **TOL[dtype])
    assert torch.all(got[:, :, ~rows] == 0)
    for name, a, b in zip("qkv", g_got, g_want):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), **GRAD_TOL[dtype],
                                   msg=lambda m, n=name: f"d{n}: {m}")


@requires_cuda
def test_flash_attention_lse_and_dead_rows():
    """lse is the row log-sum-exp of the scaled scores; a row with no live
    key (sliding window before position 0) comes out 0."""
    q = _randn(1, 2, 40, 32, dtype=torch.float32, seed=12)
    k = _randn(1, 2, 64, 32, dtype=torch.float32, seed=13)
    out, lse = flash_attention(q, k, k, kind="causal")
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 32 ** -0.5
    s = s.masked_fill(torch.arange(40, device="cuda")[:, None]
                      < torch.arange(64, device="cuda")[None, :], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    out, _ = flash_attention(q, k, k, kind="chunked", chunk=16, q_offset=-8)
    torch.cuda.synchronize()
    assert torch.all(out[:, :, :8] == 0)       # positions -8..-1: no live key


#: lengths on and around the bf16 kernels' tiles (16-row warps, 32- and 64-row
#: tiles, 64- and 128-row blocks); each Sq meets two other Sk
_EDGES = (1, 63, 64, 65, 127, 128, 129, 1000)
_EDGE_PAIRS = [(sq, _EDGES[(i + s) % len(_EDGES)])
               for i, sq in enumerate(_EDGES) for s in (1, 4)]


@requires_cuda
@pytest.mark.parametrize("q_offset", [-8, 0, 128])
@pytest.mark.parametrize("Sq,Sk", _EDGE_PAIRS)
def test_flash_attention_bf16_tile_edges(Sq, Sk, q_offset):
    _attention_matches_plain(1, 4, 2, Sq, Sk, 64, q_offset, "causal", {}, torch.bfloat16,
                             seed=20)


@requires_cuda
@pytest.mark.parametrize("kind,kw", [("causal", {}), ("sliding", {"window": 100}),
                                     ("chunked", {"chunk": 96}), ("bidirectional", {})])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_attention_bf16_masks_and_head_dims(kind, kw, D):
    _attention_matches_plain(2, 4, 2, 200, 330, D, 65, kind, kw, torch.bfloat16, seed=20)


@requires_cuda
@pytest.mark.parametrize("kind,kw", [("causal", {}), ("bidirectional", {})])
def test_flash_attention_bf16_gqa_g8(kind, kw):
    _attention_matches_plain(2, 16, 2, 300, 300, 128, 0, kind, kw, torch.bfloat16, seed=20)


@requires_cuda
@pytest.mark.parametrize("kind,kw,q_offset", [
    ("sliding", {"window": 1}, 0),          # one live key per row
    ("sliding", {"window": 2}, 0),          # one or two
    ("chunked", {"chunk": 64}, 0),          # rows just past a chunk boundary
    ("chunked", {"chunk": 50}, -3),
])
def test_flash_attention_bf16_few_key_rows(kind, kw, q_offset):
    """Rows with one or two live keys: each row of dS = P (dP - delta) must
    sum to 0, which an inexact delta breaks first here."""
    _attention_matches_plain(2, 8, 2, 256, 256, 128, q_offset, kind, kw, torch.bfloat16,
                             seed=20)


@requires_cuda
def test_flash_attention_bf16_is_deterministic():
    """No atomics: two calls give bit-identical out, lse, dq, dk and dv."""
    dt = torch.bfloat16
    q = _randn(2, 16, 1000, 128, dtype=dt, seed=30)
    k = _randn(2, 2, 1000, 128, dtype=dt, seed=31)
    v = _randn(2, 2, 1000, 128, dtype=dt, seed=32)
    dout = _randn(2, 16, 1000, 128, dtype=dt, seed=33)
    runs = []
    for _ in range(2):
        out, lse = flash_attention(q, k, v)
        runs.append((out, lse, *flash_attention_bwd(q, k, v, out, lse, dout)))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@requires_cuda
def test_flash_attention_smem_bytes_match_the_kernels():
    """smem_footprint_bytes is what the bf16 kernels take, for every head dim."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import SUPPORTED_D
    from repro_torch.kernels.flash_attention import smem_footprint_bytes

    lib = _build.load("flash_attention")
    for d in SUPPORTED_D:
        got = {}
        for key in ("fwd", "bwd_dq", "bwd_dkdv"):
            fn = getattr(lib, f"flash_attention_{key}_smem_bytes")
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
            got[key] = fn(d)
        assert got == smem_footprint_bytes(d), d
        assert max(got.values()) <= bmm.SMEM_BUDGET
    assert lib.flash_attention_fwd_smem_bytes(48) == -1


@requires_cuda
def test_kernels_refuse_what_they_do_not_take():
    q = torch.zeros(1, 2, 80, device="cuda", dtype=torch.bfloat16)
    cache = torch.zeros(1, 2, 8, 80, device="cuda", dtype=torch.bfloat16)
    L = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(q, cache, cache, L)
    with pytest.raises(TypeError):
        flash_decode(q[..., :64].half(), cache[..., :64].half(),
                     cache[..., :64].half(), L)
    with pytest.raises(ValueError, match="contiguous"):
        c = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.bfloat16)
        flash_decode(q[..., :64].contiguous(), c.transpose(1, 2), c.transpose(1, 2), L)
    x = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        flash_attention(x, x, x, kind="sliding")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x[..., :48].contiguous(), x[..., :48].contiguous(),
                        x[..., :48].contiguous())
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="k_lengths"):
        ops.attention(x, x, x, k_lengths=torch.ones(1, device="cuda"))


@requires_cuda
def test_model_on_card_matches_cpu():
    """A float32 smoke model: prefill_at then decode steps on the card and
    on the CPU, same weights — same greedy tokens, close logits."""
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    gparams = tree_map(lambda t: t.cuda(), params)
    caches = {d: tb.init_cache(2, 32, device=d) for d in ("cpu", "cuda")}
    p = {"cpu": params, "cuda": gparams}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tb.cfg.vocab, (2, 6)).astype(np.int32)
    nl = np.asarray([6, 3], np.int32)
    out = {}
    for d in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.array(a)).to(d)  # noqa: E731
        lg, _ = tb.prefill_at(p[d], {"tokens": t(toks), "new_lens": t(nl)},
                              caches[d], t(np.zeros(2, np.int32)))
        seq = [lg]
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        for s in range(3):
            lg, _ = tb.decode_step(p[d], {"tokens": tok, "lengths": t(nl + s)},
                                   caches[d])
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            seq.append(lg)
        out[d] = [x.cpu() for x in seq]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    for a, b in zip(tree_leaves(caches["cpu"]), tree_leaves(caches["cuda"])):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)


@requires_cuda
@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2), ("dots", 2)])
def test_train_loss_on_card_matches_cpu(remat, fwd_per_layer):
    """A float32 smoke model's loss and grads on the card (flash-attention
    forward and backward kernels) and on the CPU (plain attention), same
    weights and batch; under remat the forward kernel runs again in the
    backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tb.cfg.vocab, (2, 40)).astype(np.int32))
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(d, copy=True).requires_grad_(), params)
        f0, b0 = flash_attention.launches, flash_attention_bwd.launches
        loss, _ = tb.train_loss(p, {"tokens": toks.to(d), "labels": toks.to(d)},
                                remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if d == "cuda":
            torch.cuda.synchronize()
            L = tb.cfg.n_layers
            assert flash_attention.launches - f0 == fwd_per_layer * L
            assert flash_attention_bwd.launches - b0 == L
        out[d] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5, rtol=1e-5)
    # gradients leaf by leaf at 1e-3 x the leaf's largest |value|: the norm
    # over 0.02-scale embeddings scales f32 rounding by ~1/RMS ~ 50 into the
    # input-embedding rows (the CPU parity tests see the same against the
    # reference), and the card sums in other orders than the CPU
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, w, atol=1e-3 * float(w.abs().max()), rtol=1e-4)


# ---------------------------------------------------------------------------
# the SSD scan kernel and the Mamba-2 path
# ---------------------------------------------------------------------------

def _ssd_inputs(B, T, H, P, N, dtype, seed, state=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    x = (r(B, T, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(r(B, T, H)) * 0.1
    A = -torch.exp(r(H) * 0.5)
    Bm, Cm = (r(B, T, N) * 0.5).to(dtype), (r(B, T, N) * 0.5).to(dtype)
    h0 = r(B, H, P, N) if state else None
    return x, dt, A, Bm, Cm, h0


def _scaled(got, want, rel):
    """|got - want| <= rel x max|want| + rel |want|: the scale-aware bound
    of the reference's fast-path tests, for outputs and f32 states."""
    w = want.float()
    torch.testing.assert_close(got.float(), w, atol=rel * float(w.abs().max()),
                               rtol=rel)


#: y: bf16 rounds the kernel's f32 result once (<= 2^-8 relative) and the
#: plain version rounds the same f32 sums in another order; f32 sums in
#: another order.  The f32 state: 1e-4 x the leaf's max |value|.
SSD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,P,N,state", [
    (2, 256, 6, 64, 128, True),     # mamba2-780m's P, N
    (2, 100, 4, 64, 64, True),      # zamba2-1.2b's P, N, ragged T
    (3, 1, 2, 32, 16, True),        # the smoke P, N, one position
    (2, 257, 3, 32, 32, False),     # one past a chunk, no state
])
def test_ssd_kernel_matches_plain(B, T, H, P, N, state, dtype):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, T, H, P, N, dtype, seed=T + N, state=state)
    before = ssd_scan.launches
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=T, init_state=h0,
                                  return_state=True)
    _scaled(y, want_y, SSD_TOL[dtype])
    _scaled(h, want_h, 1e-4)
    seq = ref.ssd_scan_sequential(x, dt, A, Bm, Cm, init_state=h0)
    _scaled(y, seq, SSD_TOL[dtype])


@requires_cuda
def test_ssd_kernel_state_in_place_strided_and_zero_dt_rows():
    """The state written into the init buffer itself; x, B, C as slices of
    one conv output (as the model passes them); a row with dt = 0 keeps its
    state bit for bit, a row with dt = 0 past 40 positions has the state of
    those 40."""
    B, T, H, P, N = 3, 90, 4, 64, 64
    g = torch.Generator(device="cuda").manual_seed(21)
    conv = torch.randn(B, T, H * P + 2 * N, generator=g, device="cuda") * 0.5
    x = conv[..., :H * P].reshape(B, T, H, P)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    assert not x.is_contiguous() and not Bm.is_contiguous()
    _, dt, A, _, _, h0 = _ssd_inputs(B, T, H, P, N, torch.float32, seed=22)
    dt[1] = 0.0
    dt[2, 40:] = 0.0
    want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=T, init_state=h0,
                                  return_state=True)
    buf = h0.clone()
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=buf, return_state=True,
                        state_out=buf)
    torch.cuda.synchronize()
    assert h is buf
    _scaled(y, want_y, 1e-4)
    _scaled(buf, want_h, 1e-4)
    assert torch.equal(buf[1], h0[1])
    _, h40 = ops.ssd_scan(x[2:, :40], dt[2:, :40], A, Bm[2:, :40], Cm[2:, :40],
                          init_state=h0[2:].contiguous(), return_state=True)
    _scaled(buf[2], h40[0], 1e-4)


def _ssd_kernel_matches_plain(B, T, H, P, N, dtype, seed, state=True):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, T, H, P, N, dtype, seed=seed, state=state)
    before = ssd_scan.launches
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=T, init_state=h0,
                                  return_state=True)
    _scaled(y, want_y, SSD_TOL[dtype])
    _scaled(h, want_h, 1e-4)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,P,N,hb", [
    (2, 3, 64, 128, 2),      # one block of 2 heads, one of 1 (an idle head)
    (2, 6, 32, 64, 4),       # 4 + 2 of a possible 4
    (2, 5, 32, 16, 6),       # more heads a block than H
    (8, 48, 64, 128, None),  # the serving shape's own choice (3: 128 blocks)
    (8, 64, 64, 64, None),   # zamba2's (3: 21 blocks of 3 and one of 1 a row)
])
def test_ssd_kernel_heads_off_the_block(B, H, P, N, hb, dtype, monkeypatch):
    """H not a multiple of the heads a bf16 block carries (forced where
    given): idle head slots neither read nor write."""
    from repro_torch.kernels import ssd_scan as mod

    if hb is not None:
        monkeypatch.setattr(mod, "heads_per_block", lambda *args: hb)
    _ssd_kernel_matches_plain(B, 64, H, P, N, dtype, seed=H + P)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 257])
def test_ssd_kernel_lengths_off_the_chunk(T, dtype):
    """T at and around the chunk's multiples, mamba2-780m's P and N."""
    _ssd_kernel_matches_plain(2, T, 6, 64, 128, dtype, seed=T)


@requires_cuda
def test_ssd_kernel_serving_shape_zero_dt_and_in_place():
    """The mamba2-780m serving shape (B 8, T 256, H 48, P 64, N 128) in
    bf16: a row whose dt is 0 throughout keeps its state bit for bit, and
    the state written into the initial-state buffer equals the state in a
    fresh buffer, with the same y."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(8, 256, 48, 64, 128, torch.bfloat16, seed=90)
    dt[0] = 0.0
    dt[3, 100:] = 0.0
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
    buf = h0.clone()
    y2, h2 = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=buf, return_state=True,
                          state_out=buf)
    torch.cuda.synchronize()
    assert h2 is buf
    assert torch.equal(h[0], h0[0])
    assert torch.equal(buf, h) and torch.equal(y2, y)
    want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=64, init_state=h0,
                                  return_state=True)
    _scaled(y, want_y, SSD_TOL[torch.bfloat16])
    _scaled(h, want_h, 1e-4)


@requires_cuda
def test_ssd_kernel_strided_bf16_as_the_model_passes_them():
    """x, B and C as bf16 slices of one conv output of width H P + 2 N, as
    models/ssm.py passes them (mamba2-780m: 3072 + 256), and as slices
    whose rows are not 16-byte aligned (copied by the wrapper)."""
    B, T, H, P, N = 2, 100, 48, 64, 128
    g = torch.Generator(device="cuda").manual_seed(91)
    _, dt, A, _, _, h0 = _ssd_inputs(B, T, H, P, N, torch.float32, seed=92)
    for pad in (0, 1):
        conv = (torch.randn(B, T, H * P + 2 * N + pad, generator=g, device="cuda")
                * 0.5).to(torch.bfloat16)
        x = conv[..., pad:pad + H * P].reshape(B, T, H, P)
        Bm = conv[..., pad + H * P:pad + H * P + N]
        Cm = conv[..., pad + H * P + N:]
        assert not x.is_contiguous() and not Bm.is_contiguous()
        y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
        torch.cuda.synchronize()
        want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=T, init_state=h0,
                                      return_state=True)
        _scaled(y, want_y, SSD_TOL[torch.bfloat16])
        _scaled(h, want_h, 1e-4)


@requires_cuda
def test_decode_and_scan_smem_bytes_match_the_kernels():
    """The Python mirrors that chip_smoke.py logs against the C layouts."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ssd_scan as scan

    fn = _build.load("decode_attention").decode_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for D in dec.SUPPORTED_D:
        assert fn(D) == dec.smem_bytes(D)
    fn = _build.load("ssd_scan").ssd_scan_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for P in scan.SUPPORTED_P:
        for N in scan.SUPPORTED_N:
            for hb in range(1, scan.MAX_WARPS // (P // 16) + 1):
                assert fn(P, N, hb) == scan.smem_bytes(P, N, hb)


@requires_cuda
def test_ssd_kernel_refuses_what_it_does_not_take():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(1, 8, 2, 64, 128, torch.bfloat16, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ops.ssd_scan(x.requires_grad_(), dt, A, Bm, Cm)
    x = x.detach()
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(x[..., :48], dt, A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, A, Bm, Cm, init_state=h0.transpose(2, 3), return_state=True)


@requires_cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_model_on_card_matches_cpu(arch):
    """A float32 smoke model: prefill_at chunks then decode steps on the
    card and on the CPU, same weights — same greedy tokens, close logits,
    the caches at 1e-4 x each leaf's scale; one scan launch per M layer
    per dispatch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    p = {"cpu": params, "cuda": tree_map(lambda t: t.cuda(), params)}
    caches = {d: tb.init_cache(3, 32, device=d) for d in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tb.cfg.vocab, (3, 6)).astype(np.int32)
    nl = np.asarray([6, 3, 0], np.int32)
    n_m = tb.cfg.layer_codes().count("M")
    out = {}
    for d in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.array(a)).to(d)  # noqa: E731
        before = ssd_scan.launches
        lg, _ = tb.prefill_at(p[d], {"tokens": t(toks), "new_lens": t(nl)},
                              caches[d], t(np.zeros(3, np.int32)))
        seq = [lg[:2]]
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        for s in range(3):
            lg, _ = tb.decode_step(p[d], {"tokens": tok, "lengths": t(nl + s)},
                                   caches[d])
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            seq.append(lg)
        if d == "cuda":
            torch.cuda.synchronize()
            assert ssd_scan.launches - before == n_m
        out[d] = [x.cpu() for x in seq]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    for a, b in zip(tree_leaves(caches["cpu"]), tree_leaves(caches["cuda"])):
        _scaled(b.cpu(), a, 1e-4)


# ---------------------------------------------------------------------------
# the serve steps as CUDA graphs
# ---------------------------------------------------------------------------

def _fixed(engine) -> dict:
    """Every tensor a captured serve step reads or writes."""
    out = {f"state.{k}": v for k, v in engine.state.buffers.items()}
    out.update({f"prefill.{k}": v for k, v in engine.prefill_in.items()})
    out["out"] = engine.out
    out.update({f"cache.{i}": t for i, t in enumerate(tree_leaves(engine.caches))})
    return out


def _replay_equals_eager(engine, name) -> None:
    """From one snapshot, a replay of graph ``name`` and an eager call of
    the step it captured write the same buffers and caches bit for bit;
    the snapshot is restored after, so the server's mirrors stay true."""
    fixed = _fixed(engine)
    snap = {k: t.clone() for k, t in fixed.items()}
    engine._graphs[name].replay()
    torch.cuda.synchronize()
    graphed = {k: t.clone() for k, t in fixed.items()}
    for k, t in fixed.items():
        t.copy_(snap[k])
    getattr(engine, f"_{name}_step")()
    torch.cuda.synchronize()
    assert any(not torch.equal(graphed[k], snap[k]) for k in fixed), "wrote nothing"
    for k, t in fixed.items():
        assert torch.equal(graphed[k], t), k
        t.copy_(snap[k])


def _graph_server(arch="yi-6b", dtype="bfloat16", **kw):
    from repro_torch.serve import ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype=dtype))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    return Server(tb, ServeConfig(batch_slots=3, max_len=64, prefill_chunk=8),
                  params, device="cuda", **kw)


@requires_cuda
@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b"])
def test_decode_graph_replay_matches_eager_step_after_admission_and_retirement(arch):
    """The decode graph, replayed after an admission and after a
    retirement changed the fixed state buffers in place, writes what the
    eager step writes from the same state, bit for bit: the sampled
    tokens of a temperature/top-k/top-p request (a function of every
    logit), the greedy ones, lengths and every cache leaf."""
    from repro_torch.serve import SamplingParams

    server = _graph_server(arch)
    eng = server.engine
    assert eng.graphed and set(eng.graph_launches) == {"decode", "prefill"}
    server.submit(np.arange(1, 12), max_new_tokens=2)
    server.submit(np.arange(5, 9), max_new_tokens=9,
                  sampling=SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=7))
    server.step()                                   # admission + one replay
    _replay_equals_eager(eng, "decode")
    server.step()
    server.step()                                   # the first request retires
    assert len(server.table.active_slots()) == 1
    _replay_equals_eager(eng, "decode")
    server.submit(np.arange(2, 30), max_new_tokens=3)
    server.step()                                   # admission into the freed slot
    _replay_equals_eager(eng, "decode")
    assert eng.counters["decode_replays"] == eng.counters["decode_steps"] == 4


@requires_cuda
def test_graph_and_eager_servers_give_the_same_tokens():
    """The same requests through a graphed and an eager server on the
    same weights: the same tokens per rid, greedy and sampled, and the
    graph's launches per replay x replays equal the layer counts x steps."""
    from repro_torch.serve import SamplingParams

    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (9, 30, 2, 17, 1)]
    runs = {}
    for eager in (False, True):
        server = _graph_server("yi-6b", eager=eager)
        reqs = [server.submit(p, max_new_tokens=6, sampling=SamplingParams(
                    temperature=0.7 * (i % 2), top_k=10, seed=i))
                for i, p in enumerate(prompts)]
        server.run_until_done(max_steps=200)
        runs[eager] = ([r.out_tokens for r in reqs], server)
    assert runs[False][0] == runs[True][0]
    eng = runs[False][1].engine
    st = eng.counters
    L = eng.bundle.cfg.n_layers
    assert eng.graph_launches["decode"] == {"decode_attention": L}
    assert eng.graph_launches["prefill"] == {"prefill_attention": L}
    assert st["decode_replays"] == st["decode_steps"] > 0
    assert st["prefill_replays"] == st["prefill_dispatches"] > 0
    assert runs[True][1].engine.counters["decode_replays"] == 0


@requires_cuda
def test_prefill_graph_leaves_rows_without_new_tokens_bit_for_bit():
    server = _graph_server("zamba2-1.2b")
    for n in (9, 6, 12):
        server.submit(np.arange(1, 1 + n), max_new_tokens=4)
    server.step()
    eng = server.engine
    lengths = server.table.lengths.copy()
    eng._prefill_up.put({"tokens": np.full((3, 8), 5, np.int32),
                         "new_lens": np.asarray([0, 5, 0], np.int32),
                         "offsets": lengths})
    torch.cuda.synchronize()
    before = [t.clone() for t in tree_leaves(eng.caches)]
    eng._graphs["prefill"].replay()
    torch.cuda.synchronize()
    moved = False
    for old, new in zip(before, tree_leaves(eng.caches)):
        for row in (0, 2):
            assert torch.equal(old[:, row], new[:, row])
        moved |= not torch.equal(old[:, 1], new[:, 1])
    assert moved
    _replay_equals_eager(eng, "prefill")


_CAPTURE_SCRIPT = r"""
import dataclasses, pathlib, sys
import numpy as np, torch
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.serve import ServeConfig, Server
from repro_torch.serve.engine import Executor

assert not _build._LIBS
tb = ModelBundle(dataclasses.replace(smoke_config("zamba2-1.2b"), dtype="bfloat16"))
params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
cfg = ServeConfig(batch_slots=2, max_len=32, prefill_chunk=4)
# nothing built: the warm-up before each capture builds every kernel
server = Server(tb, cfg, params, device="cuda")
assert {"decode_attention", "prefill_attention", "ssd_scan"} <= set(_build._LIBS)
built = sorted(p.name for p in pathlib.Path(_build.build_dir()).glob("*.so"))
assert built, built
req = server.submit(np.arange(1, 7), max_new_tokens=3)
server.run_until_done(max_steps=20)
assert req.done and len(req.out_tokens) == 3

# a step that cannot be captured raises; nothing falls back to eager
def bad_step(self):
    self.state["lengths"].sum().item()
Executor._decode_step = bad_step
try:
    Executor(tb, cfg, params, "cuda")
except RuntimeError as e:
    print("capture refused:", str(e).splitlines()[0])
    sys.exit(0)
sys.exit("a capture that syncs the host did not raise")
"""


@requires_cuda
def test_capture_builds_its_kernels_first_and_a_failed_capture_raises(tmp_path):
    """In a fresh process with an empty build directory, constructing a
    server builds every kernel in the warm-up before the capture and then
    serves; a step that cannot be captured raises from the constructor."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "kernels"))
    res = subprocess.run([sys.executable, "-c", _CAPTURE_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "capture refused" in res.stdout


# ---------------------------------------------------------------------------
# the GEMM study's kernel and the memory microbenchmark kernels
# ---------------------------------------------------------------------------

#: outputs of RMS ~1 (b is scaled by 1/sqrt(K)): f32 sums over K terms in
#: another order than the plain version's (f32 out, from either input
#: dtype: a bf16 product is exact in f32); one bf16 rounding of the same f32
#: sum, < 2^-7 relative (bf16 out)
MM_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
          torch.float32: dict(atol=1e-4, rtol=1e-4)}
MM_CASES = [(t, dt, out) for t in bmm.TILINGS
            for dt in (torch.float32, torch.bfloat16)
            for out in (torch.float32, torch.bfloat16)
            if bmm.supported(*t, dt.itemsize)]


def _mm_inputs(M, N, K, dtype, seed):
    a = _randn(M, K, dtype=torch.float32, seed=seed)
    b = _randn(K, N, dtype=torch.float32, seed=seed + 1) * K ** -0.5
    return a.to(dtype), b.to(dtype)


@requires_cuda
@pytest.mark.parametrize("tiling,dtype,out_dtype", MM_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_blocked_matmul_matches_plain(tiling, dtype, out_dtype):
    """Every instantiation, in both input and both output dtypes, against
    the plain version on the same inputs; one launch through ops.matmul."""
    bm, bn, bk = tiling
    a, b = _mm_inputs(2 * bm, 2 * bn, 2 * bk, dtype, seed=20)
    before = bmm.blocked_matmul.launches
    got = ops.matmul(a, b, out_dtype=out_dtype, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert bmm.blocked_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (2 * bm, 2 * bn)
    torch.testing.assert_close(got.float(), ref.matmul(a, b, out_dtype=out_dtype).float(),
                               **MM_TOL[out_dtype])


@requires_cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiling", bmm.TILINGS, ids=str)
def test_blocked_matmul_bf16_ring_wraps(tiling, out_dtype):
    """K = 16 bk: more K steps than the ring has stages, so every stage is
    filled, released and refilled several times (one stage at (256, 128,
    256))."""
    bm, bn, bk = tiling
    a, b = _mm_inputs(2 * bm, 2 * bn, 16 * bk, torch.bfloat16, seed=24)
    got = bmm.blocked_matmul(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.matmul(a, b, out_dtype=out_dtype).float(),
                               **MM_TOL[out_dtype])


@requires_cuda
@pytest.mark.parametrize("M,N,K,tiling", [
    (768, 640, 2304, (256, 128, 64)),    # non-square, 36 K steps
    (384, 1152, 96, (128, 128, 32)),     # fewer K steps than stages
    (1280, 384, 1024, (256, 128, 256)),  # one stage, tall
])
def test_blocked_matmul_bf16_non_square(M, N, K, tiling):
    a, b = _mm_inputs(M, N, K, torch.bfloat16, seed=26)
    got = bmm.blocked_matmul(a, b, bm=tiling[0], bn=tiling[1], bk=tiling[2],
                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul(a, b, out_dtype=torch.float32),
                               **MM_TOL[torch.float32])


@requires_cuda
def test_blocked_matmul_smem_bytes_match_the_kernel():
    """traffic_model's smem_bytes is what each tiling's kernel allocates, in
    both input dtypes (the bf16 ring, the f32 single stage)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("blocked_matmul").blocked_matmul_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_long
    for t in bmm.TILINGS:
        for code, itemsize in ((1, 2), (0, 4)):
            want = bmm.traffic_model(*t, *t, itemsize=itemsize)["smem_bytes"]
            assert fn(*t, code) == want, (t, itemsize)
    assert fn(64, 64, 64, 1) == -1


@requires_cuda
def test_blocked_matmul_smem_and_refusals():
    """Tilings without an instantiation, or whose tiles the traffic model
    puts over 227 KB of shared memory (f32 at (256, 128, 256)), and shapes
    off the tiling raise before any launch; every tiling the model puts
    within 227 KB launches (test_blocked_matmul_matches_plain)."""
    fits = {(t, dt) for t in bmm.TILINGS for dt in (4, 2)
            if bmm.traffic_model(*t, *t, itemsize=dt)["smem_bytes"] <= 232_448}
    assert {(t, dt.itemsize) for t, dt, _ in MM_CASES} == fits
    a, b = _mm_inputs(512, 256, 512, torch.float32, seed=22)
    before = bmm.blocked_matmul.launches
    for kw in (dict(bm=64, bn=64, bk=64), dict(bm=256, bn=128, bk=256)):
        with pytest.raises(ValueError, match="no instantiation"):
            bmm.blocked_matmul(a, b, **kw)
    with pytest.raises(ValueError, match="not a multiple"):
        bmm.blocked_matmul(a[:384], b, bm=256)
    with pytest.raises(TypeError):
        bmm.blocked_matmul(a.half(), b.half(), bm=128, bn=128, bk=128)
    assert bmm.blocked_matmul.launches == before


@requires_cuda
@pytest.mark.parametrize("where", ["cuda", "pinned"])
def test_membench_read_and_fill(where):
    """Fill then read n floats on the card or in pinned host memory read in
    place: a sum of ones is n exactly, and a random buffer sums to the
    plain version's f64 sum within f32 rounding.  Pageable host memory is
    refused by the C side's pointer check."""
    n = 2 ** 20 + 3                      # a tail past the 16-byte vectors
    x = torch.empty(n, dtype=torch.float32, device="cuda" if where == "cuda" else "cpu")
    if where == "pinned":
        x = x.pin_memory()
    before = (membench.stream_read.launches, membench.stream_fill.launches)
    ops.stream_fill(x, 1.0, device="cuda")
    total = ops.stream_read(x, device="cuda")
    torch.cuda.synchronize()
    assert float(total) == n
    assert bool((x == 1.0).all())
    assert (membench.stream_read.launches, membench.stream_fill.launches) == (
        before[0] + 1, before[1] + 1)
    r = _randn(n, dtype=torch.float32, seed=23).to(x.device)
    r = r.pin_memory() if where == "pinned" else r
    got = float(ops.stream_read(r, device="cuda"))
    want = float(ref.stream_read(r))
    assert abs(got - want) <= 1e-5 * float(r.abs().sum())
    with pytest.raises(RuntimeError, match="membench"):
        membench.stream_read(torch.ones(1024))


@requires_cuda
def test_membench_reads_on_two_streams_keep_their_own_sums():
    """Reads queued on two streams at once each sum their own buffer: the
    count of finished blocks that picks the last block is each call's own."""
    n = 2 ** 24
    xs = [torch.full((n,), v, device="cuda") for v in (1.0, 2.0)]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    sums = ([], [])
    for _ in range(20):
        for x, st, out in zip(xs, streams, sums):
            with torch.cuda.stream(st):
                out.append(membench.stream_read(x))
    torch.cuda.synchronize()
    assert [[float(t) for t in out] for out in sums] == [[n] * 20, [2 * n] * 20]


@requires_cuda
@pytest.mark.parametrize("where", ["cuda", "pinned"])
def test_membench_chase_ends_where_numpy_does(where):
    rng = np.random.default_rng(0)
    n, steps = 4096, 2048
    order = rng.permutation(n)
    perm = np.empty(n, np.int32)
    perm[order[:-1]] = order[1:]
    perm[order[-1]] = order[0]
    walk = [5]
    for _ in range(2 * steps):
        walk.append(perm[walk[-1]])
    t = torch.from_numpy(perm)
    t = t.cuda() if where == "cuda" else t.pin_memory()
    pos = torch.full((), 5, dtype=torch.int32, device="cuda")
    before = membench.chase.launches
    assert ops.chase(t, steps, pos, device="cuda") is pos
    torch.cuda.synchronize()
    assert int(pos) == walk[steps]
    ops.chase(t, steps, pos, device="cuda")       # goes on where it stopped
    assert int(pos) == walk[2 * steps]
    assert membench.chase.launches == before + 2
    plain = torch.full((), 5, dtype=torch.int32, device="cuda")
    assert int(ref.chase(t.cuda(), 2 * steps, plain)) == walk[2 * steps]
