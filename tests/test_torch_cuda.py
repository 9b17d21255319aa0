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
from repro_torch.kernels.ssd_scan import BWD_CHUNK, ssd_scan, ssd_scan_bwd
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
@pytest.mark.parametrize("kv_head", [0, 3])
def test_kv_head_reads_one_head_of_a_replicated_cache(kv_head, dtype):
    """yi-6b at ``model`` 8: a rank's 4 query heads attend one of the 4
    replicated kv heads of a B = 8 cache, read in place (one launch a
    kernel, the head slice never made contiguous), equal to the plain
    versions over the slice; the prefill kernel reads the same head of
    the chunk's keys."""
    B, Hq, Hc, D, S, Sn = 8, 4, 4, 128, 512, 64
    q = _randn(B, Hq, D, dtype=dtype, seed=80)
    k = _randn(B, Hc, S, D, dtype=dtype, seed=81)
    v = _randn(B, Hc, S, D, dtype=dtype, seed=82)
    L = torch.tensor([1, 512, 300, 37, 64, 65, 499, 128], dtype=torch.int32, device="cuda")
    before = (flash_decode.launches, flash_prefill.launches)
    got = ops.decode_attention(q, k, v, L, kv_head=kv_head)
    h = slice(kv_head, kv_head + 1)
    torch.testing.assert_close(got.float(), ref.decode_attention(
        q, k[:, h].contiguous(), v[:, h].contiguous(), L).float(), **TOL[dtype])
    qp = _randn(B, Hq, Sn, D, dtype=dtype, seed=83)
    kn = _randn(B, Hc, Sn, D, dtype=dtype, seed=84)
    vn = _randn(B, Hc, Sn, D, dtype=dtype, seed=85)
    off = torch.tensor([0, 448, 100, 7, 200, 300, 1, 64], dtype=torch.int32, device="cuda")
    q_pos = (off[:, None] + torch.arange(Sn, device="cuda", dtype=torch.int32)).contiguous()
    r = torch.arange(S, device="cuda", dtype=torch.int32)[None]
    k_pos = torch.cat([torch.where(r < off[:, None], r, -1), q_pos], 1).contiguous()
    got = ops.prefill_attention(qp, k, v, q_pos, k_pos, k_new=kn, v_new=vn, kv_head=kv_head)
    want = ref.prefill_attention(qp, torch.cat([k[:, h], kn[:, h]], 2),
                                 torch.cat([v[:, h], vn[:, h]], 2), q_pos, k_pos)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert (flash_decode.launches, flash_prefill.launches) == (before[0] + 1, before[1] + 1)


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


def _attention_matches_plain(B, Hq, Hkv, Sq, Sk, D, q_offset, kind, kw, dtype, seed=8,
                             Dv=None):
    """ops.attention's kernels, forward and backward (one launch each),
    against ref.attention and autograd through it, at TOL / GRAD_TOL; v is
    ``Dv`` wide (default ``D``).  Rows without a live key carry no
    cotangent and must come out 0 (the plain version gives the mean of V
    there)."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
    Dv = Dv or D
    q = _randn(B, Hq, Sq, D, dtype=dtype, seed=seed).requires_grad_()
    k = _randn(B, Hkv, Sk, D, dtype=dtype, seed=seed + 1).requires_grad_()
    v = _randn(B, Hkv, Sk, Dv, dtype=dtype, seed=seed + 2).requires_grad_()
    dout = _randn(B, Hq, Sq, Dv, dtype=dtype, seed=seed + 3)
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


@requires_cuda
def test_flash_attention_counts_launches_by_shape():
    """Each launch adds one to its wrapper's count by (mask kind, Sq, Sk),
    beside the total: what training reads to tell an encoder-decoder's
    encoder, cross and self attention apart."""
    q = _randn(1, 2, 5, 64, dtype=torch.bfloat16, seed=14)
    k = _randn(1, 2, 7, 64, dtype=torch.bfloat16, seed=15)
    for fn in (flash_attention, flash_attention_bwd):
        fn.by_shape.clear()
    out, lse = flash_attention(q, k, k, kind="bidirectional")
    flash_attention(q, q, q, kind="causal")
    flash_attention_bwd(q, k, k, out, lse, torch.ones_like(out), kind="bidirectional")
    assert flash_attention.by_shape == {("bidirectional", 5, 7): 1, ("causal", 5, 5): 1}
    assert flash_attention_bwd.by_shape == {("bidirectional", 5, 7): 1}


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
@pytest.mark.parametrize("B,H,Sq,Sk,q_offset,kind,kw", [
    (1, 8, 2048, 2048, 0, "causal", {}),         # deepseek-v2 training (fewer heads)
    (2, 4, 77, 130, 0, "causal", {}),            # ragged: off every tile
    (2, 4, 200, 330, 65, "sliding", {"window": 100}),
    (1, 4, 129, 129, 0, "bidirectional", {}),
])
def test_flash_attention_mla_head_dims_match_plain(B, H, Sq, Sk, q_offset, kind, kw):
    """MLA's q/k head dim 192 with v head dim 128 (bf16 tensor-core
    kernels), forward and backward, natively: no padding."""
    _attention_matches_plain(B, H, H, Sq, Sk, 192, q_offset, kind, kw, torch.bfloat16,
                             seed=40, Dv=128)


@requires_cuda
def test_flash_attention_pads_head_dims_it_does_not_take():
    """deepseek-v2-smoke's (24, 16) runs the f32 kernels at (32, 32), zero-
    padded, at the scale of 24 (one launch each way); (192, 128) has no
    f32 kernel and nothing wider, so it raises, padded or not."""
    _attention_matches_plain(2, 4, 4, 50, 50, 24, 0, "causal", {}, torch.float32,
                             seed=44, Dv=16)
    x = torch.zeros(1, 2, 8, 192, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        ops.attention(x, x, x[..., :128])
    with pytest.raises(ValueError, match="head dims"):
        ops.attention(x[..., :160], x[..., :160], x[..., :128])


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
def test_flash_attention_smem_bytes_match_the_kernels_at_mla_head_dims():
    """(192, 128): the C side's three kernels and smem_footprint_bytes
    agree, each under the card's budget, two blocks an SM fitting."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import smem_footprint_bytes

    fn = _build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    got = dict(zip(("fwd", "bwd_dq", "bwd_dkdv"), (fn(w, 192, 128) for w in range(3))))
    assert got == smem_footprint_bytes(192, 128) == {
        "fwd": 111_616, "bwd_dq": 86_016, "bwd_dkdv": 86_528}
    # two blocks an SM: each takes its bytes + 1 KB reserved of the SM's 228 KB
    assert 2 * (max(got.values()) + 1024) <= 228 * 1024
    assert fn(0, 192, 192) == fn(0, 128, 64) == -1


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
    # an input that requires grad takes the backward kernel
    before = ssd_scan_bwd.launches
    xg = x.clone().requires_grad_()
    ops.ssd_scan(xg, dt, A, Bm, Cm).float().sum().backward()
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 1
    want = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, torch.ones_like(x), chunk=8)[0]
    _scaled(xg.grad, want, 5e-2)
    with pytest.raises(ValueError, match="serving buffer"):
        ops.ssd_scan(xg, dt, A, Bm, Cm, init_state=h0, return_state=True, state_out=h0)
    with pytest.raises(ValueError, match="dy must be"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, x.float())
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(x[..., :48], dt, A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, A, Bm, Cm, init_state=h0.transpose(2, 3), return_state=True)


# ---------------------------------------------------------------------------
# the SSD scan's backward kernel and Mamba-2 training
# ---------------------------------------------------------------------------

#: gradients against ref.ssd_scan_bwd, per leaf at rel x its largest |value|
#: (tests/test_kernels.py:96's f32 and bf16 limits): f32 sums in another
#: order and chunking; in bf16 one rounding of the same f32 results
SSD_GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init")


def _ssd_bwd_matches_plain(x, dt, A, Bm, Cm, h0, dy, dhT, dtype):
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, init_state=h0, d_state_out=dhT)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 1
    T = x.shape[1]
    want = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=64 if T % 64 == 0 else T,
                            init_state=h0, d_state_out=dhT)
    for name, g, w, t in zip(GRAD_NAMES, got, want, (x, dt, A, Bm, Cm, h0)):
        if t is None:
            assert g is None
            continue
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _scaled(g, w, SSD_GRAD_TOL[dtype])
    return got


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,P,N,state", [
    (2, 256, 6, 64, 128, True),     # mamba2-780m's P, N, several chunks
    (2, 100, 4, 64, 64, True),      # zamba2-1.2b's P, N, T off the chunk
    (2, 16, 4, 32, 16, False),      # the smoke P, N, half a chunk
    (2, 257, 3, 32, 32, False),     # one past a chunk
    (3, 1, 2, 64, 128, True),       # one position
    (2, 1, 3, 32, 16, False),       # one position, no state
    (2, BWD_CHUNK - 1, 4, 64, 128, True),    # one short of the bf16 chunk
    (2, BWD_CHUNK + 1, 4, 64, 128, False),   # one past it
    (2, 257, 6, 64, 64, True),      # zamba2's N, four chunks and one position
])
def test_ssd_bwd_kernel_matches_plain(B, T, H, P, N, state, dtype):
    """dx, ddt, dA, dB, dC (and with a state the initial state's gradient,
    seeded by the final state's) against autograd through the plain scan."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, T, H, P, N, dtype, seed=T + N + 1, state=state)
    dy = _randn(B, T, H, P, dtype=dtype, seed=T + 5)
    dhT = _randn(B, H, P, N, dtype=torch.float32, seed=T + 6) if state else None
    _ssd_bwd_matches_plain(x, dt, A, Bm, Cm, h0, dy, dhT, dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero", ["tail", "row"])
@pytest.mark.parametrize("H,P,N", [(48, 64, 128), (64, 64, 64)])
def test_ssd_bwd_kernel_training_shapes(H, P, N, zero, dtype):
    """mamba2-780m's (H 48, P 64, N 128) and zamba2-1.2b's (H 64, P 64,
    N 64) widths at batch 2 x 512 positions (chip_smoke.py phase 8f runs
    4 x 2048).  A row whose dt is 0 past a length ("tail") gets dx = 0
    there; a row whose dt is 0 throughout ("row") gets dx = 0 and dB = 0,
    exactly."""
    B, T = 2, 512
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, T, H, P, N, dtype, seed=H, state=False)
    start = 300 if zero == "tail" else 0
    dt[1, start:] = 0.0
    dy = _randn(B, T, H, P, dtype=dtype, seed=H + 1)
    got = _ssd_bwd_matches_plain(x, dt, A, Bm, Cm, None, dy, None, dtype)
    assert not got[0][1, start:].any()
    if zero == "row":
        assert not got[3][1].any()


@requires_cuda
def test_ssd_bwd_kernel_strided_views_and_reruns():
    """x, B and C as bf16 slices of one conv output, as models/ssm.py
    passes them (rows not 16-byte aligned too); two calls in a row give
    the same gradients bit for bit."""
    B, T, H, P, N = 2, 100, 8, 64, 128
    g = torch.Generator(device="cuda").manual_seed(95)
    _, dt, A, _, _, h0 = _ssd_inputs(B, T, H, P, N, torch.float32, seed=96)
    dy = _randn(B, T, H, P, dtype=torch.bfloat16, seed=97)
    for pad in (0, 1):
        conv = (torch.randn(B, T, H * P + 2 * N + pad, generator=g, device="cuda")
                * 0.5).to(torch.bfloat16)
        x = conv[..., pad:pad + H * P].reshape(B, T, H, P)
        Bm = conv[..., pad + H * P:pad + H * P + N]
        Cm = conv[..., pad + H * P + N:]
        assert not x.is_contiguous() and not Bm.is_contiguous()
        first = _ssd_bwd_matches_plain(x, dt, A, Bm, Cm, h0, dy, None, torch.bfloat16)
        again = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, init_state=h0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_function_under_checkpoint(dtype):
    """``torch.utils.checkpoint`` around the autograd Function: the forward
    kernel runs again in the backward, the backward kernel once, and the
    gradients equal those without the checkpoint bit for bit."""
    from torch.utils.checkpoint import checkpoint

    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, 96, 4, 64, 64, dtype, seed=7)
    w = _randn(2, 96, 4, 64, dtype=dtype, seed=8)

    def f(x, dt, A, Bm, Cm, h0):
        y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
        return (y.float() * w.float()).sum() + h.square().sum()

    grads = {}
    for mode in ("plain", "checkpoint"):
        ins = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
        f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
        loss = f(*ins) if mode == "plain" else checkpoint(f, *ins, use_reentrant=False)
        grads[mode] = torch.autograd.grad(loss, ins)
        torch.cuda.synchronize()
        assert ssd_scan.launches - f0 == (1 if mode == "plain" else 2)
        assert ssd_scan_bwd.launches - b0 == 1
    assert all(torch.equal(a, b) for a, b in zip(grads["plain"], grads["checkpoint"]))


@requires_cuda
def test_ssd_bwd_smem_bytes_match_the_kernels():
    """The Python mirror of the four backward kernels' shared memory (f32
    and bf16, state and chunk pass)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as scan

    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for P in scan.SUPPORTED_P:
        for N in scan.SUPPORTED_N:
            for kernel in (0, 1, 2, 3):
                assert fn(P, N, kernel) == scan.smem_bytes_bwd(P, N, kernel)


@requires_cuda
@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2), ("dots", 2)])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_train_loss_on_card_matches_cpu(arch, remat, fwd_per_layer):
    """A float32 SSM smoke model's loss and grads on the card (the scan's
    forward and backward kernels; zamba2's S layers through the attention
    kernels) and on the CPU (the plain versions), same weights and batch,
    at test_train_loss_on_card_matches_cpu's limits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tb.cfg.vocab, (2, 40)).astype(np.int32))
    n_m = tb.cfg.layer_codes().count("M")
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(d, copy=True).requires_grad_(), params)
        f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
        loss, _ = tb.train_loss(p, {"tokens": toks.to(d), "labels": toks.to(d)},
                                remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if d == "cuda":
            torch.cuda.synchronize()
            assert ssd_scan.launches - f0 == fwd_per_layer * n_m
            assert ssd_scan_bwd.launches - b0 == n_m
        out[d] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5, rtol=1e-5)
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, w, atol=1e-3 * float(w.abs().max()), rtol=1e-4)


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

# a step that cannot be captured raises; nothing falls back to eager (it
# takes the steps' handed_back argument, which the build's audit passes)
def bad_step(self, handed_back=None):
    self.state["lengths"].sum().item()
    if handed_back is not None:
        handed_back["caches"] = self.caches
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


# ---------------------------------------------------------------------------
# host placements: the KV write-back kernel, placed serving through graphs
# ---------------------------------------------------------------------------

def _write_back_case(B, H, S, D, pos, n, dtype, seed=0):
    from repro_torch.core.placement import to_host

    src_k = _randn(B, H, S, D, dtype=dtype, seed=seed)
    src_v = _randn(B, H, S, D, dtype=dtype, seed=seed + 1)
    dst = to_host({"k": _randn(B, H, S, D, dtype=dtype, seed=seed + 2),
                   "v": _randn(B, H, S, D, dtype=dtype, seed=seed + 3)}, "cuda")
    want = {k: t.clone() for k, t in dst.items()}
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    c = torch.tensor(n, dtype=torch.int32, device="cuda")
    ref.kv_write_back(src_k, src_v, want["k"], want["v"], p, c)
    return src_k, src_v, dst, want, p, c


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,D,pos,n", [
    (8, 4, 2048, 128, [0, 7, 100, 2047, 1500, 64, 9, 2046], [1] * 8),        # decode
    (8, 4, 2048, 128, [0, 256, 1800, 1900, 5, 0, 2047, 30],
     [256, 0, 256, 200, 13, 0, 256, 1]),                                     # prefill, wrap
    (3, 1, 48, 16, [40, 3, 47], [20, 0, 100]),                               # n > S
    (8, 8, 1024, 64, [0, 256, 900, 1000, 5, 0, 1023, 30],
     [256, 256, 256, 200, 13, 0, 256, 1]),                                   # prefill, H 8, D 64
    (4, 2, 64, 256, [60, 0, 33, 7], [9, 64, 0, 70]),                         # D 256
    (8, 4, 2048, 128, [0, 7, 100, 2047, 1500, 64, 9, 2046], [0] * 8),        # nothing to write
    (8, 16, 1024, 128, [0, 900, 1000, 1023, 1500, 2047, 5, 3000],
     [256, 256, 256, 1, 256, 256, 0, 200]),                                  # gemma3's L ring
])
def test_kv_write_back_kernel_matches_plain_into_pinned_memory(B, H, S, D, pos, n, dtype):
    from repro_torch.kernels.kv_stream import kv_write_back

    src_k, src_v, dst, want, p, c = _write_back_case(B, H, S, D, pos, n, dtype)
    assert dst["k"].is_pinned()
    before = kv_write_back.launches
    kv_write_back(src_k, src_v, dst["k"], dst["v"], p, c)
    torch.cuda.synchronize()
    assert kv_write_back.launches == before + 1
    assert torch.equal(dst["k"], want["k"]) and torch.equal(dst["v"], want["v"])
    # a rerun (through the views resolved by the first) is bit-identical
    first = {k: t.clone() for k, t in dst.items()}
    kv_write_back(src_k, src_v, dst["k"], dst["v"], p, c)
    torch.cuda.synchronize()
    assert torch.equal(dst["k"], first["k"]) and torch.equal(dst["v"], first["v"])
    # into device memory the same
    dk, dv = want["k"].cuda(), want["v"].cuda()
    kv_write_back(src_k, src_v, dk, dv, p, c)
    torch.cuda.synchronize()
    assert torch.equal(dk.cpu(), want["k"]) and torch.equal(dv.cpu(), want["v"])


@requires_cuda
def test_kv_write_back_refuses_pageable_memory_and_bad_shapes():
    from repro_torch.kernels.kv_stream import device_view, kv_write_back

    src = _randn(2, 1, 8, 16, dtype=torch.float32, seed=0)
    p = torch.zeros(2, dtype=torch.int32, device="cuda")
    pageable = torch.zeros(2, 1, 8, 16)
    with pytest.raises(RuntimeError, match="cudaError"):
        kv_write_back(src, src, pageable, pageable, p, p + 1)
    with pytest.raises(ValueError):
        kv_write_back(src, src, src[:, :, :4].contiguous(), src, p, p)
    with pytest.raises(ValueError):
        kv_write_back(src, src, src.clone(), src.clone(), p.long(), p)
    with pytest.raises(RuntimeError, match="cudaError"):
        device_view(pageable)


@requires_cuda
@pytest.mark.parametrize("policy", ["kv_host", "weights_stream",
                                    "kv=host:stream,params=host:stream"])
def test_placed_graphs_replay_after_lengths_change_and_match_hbm(policy):
    """A host-placed server's decode graph, replayed after admissions and a
    retirement changed the lengths, writes what the eager step writes
    (host cache included, bit for bit), and the placed server's tokens
    equal hbm_resident's on the same weights."""
    from repro_torch.serve import ServeConfig, Server
    from repro_torch.core.placement import Role

    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="bfloat16"))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (9, 30, 2, 17, 1)]
    tokens = {}
    for pol in ("hbm_resident", policy):
        server = Server(tb, ServeConfig(batch_slots=3, max_len=64, prefill_chunk=8,
                                        policy=pol), params, device="cuda")
        eng = server.engine
        reqs = [server.submit(p, max_new_tokens=6) for p in prompts]
        server.step()
        if pol != "hbm_resident":
            placed = eng.policy.placement(Role.KV_CACHE).on_host
            if placed:
                assert all(t.is_pinned() for t in tree_leaves(eng.caches))
                assert eng.graph_launches["decode"]["kv_stream"] == tb.cfg.n_layers
            _replay_equals_eager(eng, "decode")
            for _ in range(3):
                server.step()                # lengths moved, admissions, retirements
            _replay_equals_eager(eng, "decode")
        server.run_until_done(max_steps=200)
        tokens[pol] = [r.out_tokens for r in reqs]
        assert eng.counters["decode_replays"] == eng.counters["decode_steps"] > 0
    assert tokens[policy] == tokens["hbm_resident"]


@requires_cuda
def test_kv_host_graphs_write_back_the_same_cache_as_eager_and_hbm():
    """kv_host through the graphs, its write-back on a stream of its own:
    after prefills and decode steps over reused slots, the host cache holds
    the same bytes as an eager kv_host server's and as hbm_resident's
    device cache (a late or lost row shows there before it shows in the
    tokens), and the tokens agree."""
    from repro_torch.serve import ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="bfloat16"))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (40, 9, 50, 3, 25)]
    runs = {}
    for label, policy, eager in (("graphs", "kv_host", False), ("eager", "kv_host", True),
                                 ("hbm", "hbm_resident", False)):
        server = Server(tb, ServeConfig(batch_slots=3, max_len=64, prefill_chunk=8,
                                        policy=policy), params, device="cuda", eager=eager)
        reqs = [server.submit(p, max_new_tokens=8) for p in prompts]
        server.run_until_done(max_steps=300)
        torch.cuda.synchronize()
        eng = server.engine
        if label == "graphs":
            assert eng.counters["decode_replays"] > 8 and eng.counters["prefill_replays"] > 5
            assert eng.graph_launches["decode"]["kv_stream"] == tb.cfg.n_layers
            assert eng.graph_launches["prefill"]["kv_stream"] == tb.cfg.n_layers
        if policy == "kv_host":
            assert all(t.is_pinned() for t in tree_leaves(eng.caches))
        runs[label] = ([r.out_tokens for r in reqs],
                       [t.cpu() for t in tree_leaves(eng.caches)])
    for label in ("eager", "hbm"):
        assert runs[label][0] == runs["graphs"][0], label
        assert len(runs[label][1]) == len(runs["graphs"][1])
        for i, (a, b) in enumerate(zip(runs[label][1], runs["graphs"][1])):
            assert torch.equal(a, b), (label, i)


@requires_cuda
def test_capture_stream_is_none_of_the_host_streams():
    """PyTorch hands the streams of a per-device pool out in turn, so a
    stream drawn later may be a host stream's copy or write-back stream
    (the 10b fault of ``chip_smoke.py``: write-backs captured in line).
    A kv_host server captures its steps on a stream none of its host
    streams is, wherever the pool's cursor stands, and serves."""
    pool = {torch.cuda.Stream().cuda_stream for _ in range(256)}
    assert len(pool) < 256                       # the pool hands its streams out again
    server = _smoke_server("yi-6b", "kv_host")
    eng = server.engine
    host = {s.cuda_stream for s in eng._host_streams().values()}
    assert len(host) == 2 and eng._stream.cuda_stream not in host
    # a plain draw meets a host stream within two turns of the pool ...
    assert any(torch.cuda.Stream().cuda_stream in host for _ in range(2 * len(pool)))
    # ... a capture stream never does
    for _ in range(2 * len(pool)):
        assert eng._capture_stream().cuda_stream not in host
    eng._check_streams()
    _serve_tokens(server, _serve_prompts())
    assert eng.counters["prefill_replays"] > 0


# ---------------------------------------------------------------------------
# RESIDENT host placements: the kernels on the card's mapped view of pinned
# host memory
# ---------------------------------------------------------------------------

def _mapped(tree):
    """``tree`` copied into a pinned arena, as CUDA tensors over the card's
    mapped view of it (a RESIDENT host placement's leaves)."""
    from repro_torch.core.placement import to_host

    out = to_host(tree, "cuda", mapped=True)
    for t in tree_leaves(out):
        assert t.is_cuda and t._host_arena.pinned
        assert t._host_arena.base.is_pinned()
    return out


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_and_prefill_kernels_read_a_mapped_cache_bit_for_bit(dtype):
    """flash_decode and flash_prefill on a KV cache in pinned host memory,
    read in place through the mapped view: the same bits as the same call
    on the same cache in device memory (ragged lengths, a full row, holes)."""
    B, Hq, Hkv, D, S, Sn = 4, 16, 4, 128, 512, 64
    q = _randn(B, Hq, D, dtype=dtype, seed=70)
    k = _randn(B, Hkv, S, D, dtype=dtype, seed=71)
    v = _randn(B, Hkv, S, D, dtype=dtype, seed=72)
    m = _mapped({"k": k, "v": v})
    lens = torch.tensor([1, 200, S, 377], dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    want, got = flash_decode(q, k, v, lens), flash_decode(q, m["k"], m["v"], lens)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 2 and torch.equal(got, want)
    qq = _randn(B, Hq, Sn, D, dtype=dtype, seed=73)
    kn, vn = (_randn(B, Hkv, Sn, D, dtype=dtype, seed=s) for s in (74, 75))
    off = torch.tensor([0, 100, 448, 300], dtype=torch.int32, device="cuda")[:, None]
    nl = torch.tensor([64, 9, 64, 0], dtype=torch.int32, device="cuda")[:, None]
    j = torch.arange(Sn, dtype=torch.int32, device="cuda")[None, :]
    r = torch.arange(S, dtype=torch.int32, device="cuda")[None, :]
    q_pos = (off + j).contiguous()
    k_pos = torch.cat([torch.where(r < off, r, -1), torch.where(j < nl, off + j, -1)],
                      1).contiguous()
    want = flash_prefill(qq, k, v, q_pos, k_pos, k_new=kn, v_new=vn)
    got = flash_prefill(qq, m["k"], m["v"], q_pos, k_pos, k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_state_in_mapped_host_memory_bit_for_bit(dtype):
    """ssd_scan with its initial and final state in pinned host memory
    (mapped), separate and in place (the serving prefill's ``init_state =
    state_out``): the same bits as with the state in device memory."""
    B, T, H, P, N = 3, 100, 8, 64, 128
    x = _randn(B, T, H, P, dtype=dtype, seed=80)
    dt = torch.nn.functional.softplus(_randn(B, T, H, dtype=torch.float32, seed=81))
    A = -torch.exp(_randn(H, dtype=torch.float32, seed=82))
    Bm, Cm = (_randn(B, T, N, dtype=dtype, seed=s) for s in (83, 84))
    h0 = _randn(B, H, P, N, dtype=torch.float32, seed=85)
    y, hT = ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
    m = _mapped({"h0": h0, "out": torch.zeros_like(h0), "inplace": h0})
    y1, _ = ssd_scan(x, dt, A, Bm, Cm, init_state=m["h0"], return_state=True,
                     state_out=m["out"])
    y2, _ = ssd_scan(x, dt, A, Bm, Cm, init_state=m["inplace"], return_state=True,
                     state_out=m["inplace"])
    torch.cuda.synchronize()
    assert torch.equal(y1, y) and torch.equal(y2, y)
    assert torch.equal(m["out"], hT) and torch.equal(m["inplace"], hT)
    assert torch.equal(m["h0"], h0)                    # read, not written


@requires_cuda
def test_mapped_view_of_pageable_memory_raises():
    from repro_torch.kernels.kv_stream import mapped

    pinned = torch.arange(64, dtype=torch.uint8).pin_memory()
    view = mapped(pinned)
    assert view.is_cuda and torch.equal(view.cpu(), pinned)
    view.add_(1)                                       # the card writes host memory
    torch.cuda.synchronize()
    assert torch.equal(pinned, torch.arange(1, 65, dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="cudaError"):
        mapped(torch.zeros(64, dtype=torch.uint8))       # pageable
    with pytest.raises(ValueError):
        mapped(pinned.cuda())


@requires_cuda
@pytest.mark.parametrize("arch,policy", [
    ("yi-6b", "kv=host"), ("yi-6b", "kv=host,params=host"), ("mamba2-780m", "kv_host"),
    ("mamba2-780m", "kv=host"), ("zamba2-1.2b", "kv_host"),
])
def test_host_placed_graphs_eager_and_hbm_agree(arch, policy):
    """A RESIDENT host placement, and Mamba-2/Zamba-2 state under
    ``kv_host``, through the graphs, eagerly and as ``hbm_resident``: the
    same tokens over reused slots, and the host cache (or recurrent state)
    holds the same bytes as the eager server's and as hbm_resident's
    device cache; a RESIDENT role is a mapped view with no window, and the
    graphs launch what hbm_resident's launch."""
    from repro_torch.core.placement import Role
    from repro_torch.serve import ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="bfloat16"))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (40, 9, 50, 3, 25)]
    runs = {}
    for label, pol, eager in (("graphs", policy, False), ("eager", policy, True),
                              ("hbm", "hbm_resident", False)):
        server = Server(tb, ServeConfig(batch_slots=3, max_len=64, prefill_chunk=8,
                                        policy=pol), params, device="cuda", eager=eager)
        reqs = [server.submit(p, max_new_tokens=8) for p in prompts]
        server.run_until_done(max_steps=300)
        torch.cuda.synchronize()
        eng = server.engine
        if pol != "hbm_resident":
            leaves = tree_leaves(eng.caches)
            assert all(t._host_arena is not None for t in leaves)
            streamed = server.runtime.streamed(Role.KV_CACHE)
            assert all(t.is_pinned() if streamed else t.is_cuda for t in leaves)
            if not streamed:
                assert eng.feed is None or "kv_cache" not in eng.feed.streams()
        runs[label] = ([r.out_tokens for r in reqs],
                       [t.cpu() for t in tree_leaves(eng.caches)],
                       None if eager else eng.graph_launches)
    if not runs["graphs"][2]["decode"].get("kv_stream"):
        assert runs["graphs"][2] == runs["hbm"][2]
    for label in ("eager", "hbm"):
        assert runs[label][0] == runs["graphs"][0], label
        for i, (a, b) in enumerate(zip(runs[label][1], runs["graphs"][1])):
            assert torch.equal(a, b), (label, i)


# ---------------------------------------------------------------------------
# preemption, replan and recovery through the graphs
# ---------------------------------------------------------------------------

def _smoke_server(arch, policy="hbm_resident", slots=3, **kw):
    from repro_torch.serve import ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="bfloat16"))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    return Server(tb, ServeConfig(batch_slots=slots, max_len=64, prefill_chunk=8,
                                  policy=policy, **kw), params, device="cuda")


def _serve_prompts(seed=5, lens=(40, 9, 50, 3, 25, 17)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, n).astype(np.int32) for n in lens]


def _serve_tokens(server, prompts, new=8, hook=None):
    reqs = [server.submit(p, max_new_tokens=new + i % 3) for i, p in enumerate(prompts)]
    n = 0
    while server.has_work():
        server.step()
        n += 1
        if hook is not None:
            hook(server, n)
        assert n < 500
    return [r.out_tokens for r in reqs]


@requires_cuda
@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "kv=host"])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-780m"])
def test_slot_extract_insert_round_trip_bit_for_bit(arch, policy):
    """A live slot's rows copied out to pinned host memory and back into
    another free slot of the same captured buffers, bit for bit, with no
    capture; the slot's rows are untouched by the extract."""
    from repro_torch.core.hardware import MemoryTier
    from repro_torch.core.placement import Placement

    server = _smoke_server(arch, policy)
    eng = server.engine
    captures = eng.counters["captures"]
    for p in _serve_prompts(lens=(20, 33)):
        server.submit(p, max_new_tokens=30)
    for _ in range(4):
        server.step()
    i = server.table.active_slots()[1]
    before = [t[:, i:i + 1].clone() for t in tree_leaves(eng.caches)]
    rows = eng.extract_slot(i, Placement(MemoryTier.HOST))
    leaves = tree_leaves(rows)
    assert all(t.device.type == "cpu" and t.is_pinned() for t in leaves)
    for a, b in zip(before, leaves):
        assert torch.equal(a.cpu(), b)
    free = server.table.free_slots()[0]
    eng.insert_slot(free, rows)
    for a, t in zip(before, tree_leaves(eng.caches)):
        assert torch.equal(a, t[:, free:free + 1])
        assert torch.equal(a, t[:, i:i + 1])
    assert eng.counters["captures"] == captures
    assert eng.counters["spill_s"] > 0 and eng.counters["restore_s"] > 0
    assert eng._spill_pool == [rows]        # reused by the next spill
    assert eng.extract_slot(i, Placement(MemoryTier.HOST)) is rows


@requires_cuda
@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host"])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-780m"])
def test_preemption_through_the_graphs_keeps_tokens_and_captures(arch, policy):
    """Oversubscribed with preemption: the same greedy tokens as the
    unpreempted graphed run, every spill promoted back, spilled rows in
    pinned host memory, and not one capture after construction."""
    prompts = _serve_prompts()
    base = _serve_tokens(_smoke_server(arch, policy), prompts)
    server = _smoke_server(arch, policy, preempt=True, preempt_wait=2, verify_spills=True)
    seen = []

    def spilled(srv, n):
        seen.extend(sp.rows for sp in srv._spilled.values())

    got = _serve_tokens(server, prompts, hook=spilled)
    st = server.stats()
    assert got == base
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    assert st["captures"] == 2
    assert seen and all(t.is_pinned() for rows in seen for t in tree_leaves(rows))


@requires_cuda
def test_mid_serve_recapture_keeps_live_mamba_rows():
    """A rebuild of the steps with live Mamba-2 rows (the warm-ups run the
    step on the live state) leaves every cache leaf and the serve state
    bit for bit, captures both graphs once more, and the run's tokens are
    the uninterrupted run's; so do replans hbm_resident -> kv_host ->
    hbm_resident, each capturing both graphs once."""
    prompts = _serve_prompts()
    base = _serve_tokens(_smoke_server("mamba2-780m"), prompts)

    def rebuild(srv, n):
        if n != 3:
            return
        eng = srv.engine
        torch.cuda.synchronize()
        live = [t.clone() for t in eng._written()]
        captures = eng.counters["captures"]
        eng._build_steps()
        assert eng.counters["captures"] == captures + 2
        for a, b in zip(live, eng._written()):
            assert torch.equal(a, b)

    assert _serve_tokens(_smoke_server("mamba2-780m"), prompts, hook=rebuild) == base
    caps = []

    def replan(srv, n):
        if n in (2, 5):
            assert srv.replan("kv_host" if n == 2 else "hbm_resident")
            caps.append(srv.stats()["captures"])

    server = _smoke_server("mamba2-780m")
    assert _serve_tokens(server, prompts, hook=replan) == base
    assert caps == [4, 6] and server.stats()["migrations"] == 2
    assert server.policy.name == "hbm_resident"


@requires_cuda
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-780m"])
def test_replan_while_a_sequence_is_parked_on_the_card(arch):
    """Preempted rows parked in pinned host memory while the cache moves
    hbm_resident -> kv_host -> hbm_resident: every promotion verifies
    against its park-time checksum (summed where the rows lie, whatever
    device the cache is on by then), none is taken for corrupt, and the
    greedy tokens are the unpreempted run's."""
    prompts = _serve_prompts()
    base = _serve_tokens(_smoke_server(arch), prompts)
    moves = []

    def replan(srv, n):
        if srv._spilled and len(moves) < 2 and (not moves or n > moves[-1] + 1):
            assert srv.replan("kv_host" if not moves else "hbm_resident")
            moves.append(n)

    server = _smoke_server(arch, preempt=True, preempt_wait=2, verify_spills=True)
    assert _serve_tokens(server, prompts, hook=replan) == base
    st = server.stats()
    assert len(moves) == 2 and st["migrations"] == 2
    assert st["spill_corruptions"] == 0 and st["requeued_fresh"] == 0
    assert st["preemptions"] >= 2 and st["promotions"] == st["preemptions"]


@requires_cuda
def test_tier_loss_under_kv_host_recovers_on_the_card():
    """A host tier loss at a decode pass under kv_host: the cache moves to
    the card, both graphs are captured again, a transient migration
    failure is retried, a corrupted spill replays, and the greedy tokens
    are the no-fault run's."""
    from repro_torch.core.faults import FaultEvent, FaultKind, FaultPlan
    from repro_torch.core.hardware import MemoryTier
    from repro_torch.core.placement import Role

    prompts = _serve_prompts()
    base = _serve_tokens(_smoke_server("yi-6b", "kv_host"), prompts)
    plan = FaultPlan([
        FaultEvent("decode", at=8, kind=FaultKind.TIER_LOSS, tier="host"),
        FaultEvent("migrate", at=0, kind=FaultKind.MIGRATE_FAIL),
        FaultEvent("spill", at=0, kind=FaultKind.SPILL_CORRUPT),
    ])
    server = _smoke_server("yi-6b", "kv_host", preempt=True, preempt_wait=2, faults=plan)
    assert _serve_tokens(server, prompts) == base
    st = server.stats()
    assert st["tier_losses"] == 1 and st["evacuations"] == 1
    assert st["migration_retries"] >= 1 and st["spill_corruptions"] == 1
    assert st["captures"] == 4
    assert server.engine._spill_pool == []      # no spill lands on host again
    assert MemoryTier.HOST in server.runtime.lost_tiers
    assert server.policy.placement(Role.KV_CACHE).tier is MemoryTier.HBM
    assert all(t.is_cuda for t in tree_leaves(server.engine.caches))


@requires_cuda
@pytest.mark.parametrize("policy", ["hbm_resident", "kv=host"])
def test_asyncio_scheduler_replays_the_graphs_from_its_worker_thread(policy):
    """The asyncio Scheduler steps the server in a worker thread: the
    graphs replay there, with preemption on, and every client streams the
    tokens of the synchronous graphed run."""
    import asyncio

    from repro_torch.serve import Scheduler

    prompts = _serve_prompts()
    base = _serve_tokens(_smoke_server("yi-6b", policy), prompts)
    server = _smoke_server("yi-6b", policy, preempt=True, preempt_wait=2, max_queue=3)
    sched = Scheduler(server)

    async def client(i):
        req = await sched.submit(prompts[i], max_new_tokens=8 + i % 3)
        return [tok async for tok in sched.stream(req)]

    async def main():
        async def clients():
            outs = await asyncio.gather(*(client(i) for i in range(len(prompts))))
            sched.close()
            return outs
        return (await asyncio.gather(sched.run(), clients()))[1]

    assert asyncio.run(main()) == base
    st = server.stats()
    assert st["captures"] == 2 and st["decode_replays"] == st["decode_steps"] > 0


# ---------------------------------------------------------------------------
# ring caches: gemma3's L and G layers, chunk-local C decode
# ---------------------------------------------------------------------------

@requires_cuda
def test_prefill_bf16_over_gemma3_wrapped_ring():
    """The bf16 prefill kernel at gemma3-27b's serving shape (8 rows, 32/16
    heads, D 128) over an L ring of 1024 slots that has wrapped (key
    positions out of order along the cache), a 256-token chunk, the
    sliding window of 1024: against the plain version."""
    from repro_torch.models.attention import _ring_positions

    B, Sc, Sn = 8, 1024, 256
    offs = torch.tensor([0, 256, 700, 1024, 1100, 1500, 1792, 3000], dtype=torch.int32)
    nl = torch.tensor([256, 256, 256, 256, 0, 100, 256, 1], dtype=torch.int32)
    j = torch.arange(Sn, dtype=torch.int32)[None]
    q_pos = offs[:, None] + j
    k_pos = torch.cat([_ring_positions(offs, Sc), torch.where(j < nl[:, None], q_pos, -1)], 1)
    _bf16_prefill_matches_plain(B, 2, 16, 128, Sn, Sc, Sn, kind="sliding",
                                kw={"window": 1024},
                                positions=(q_pos.cuda().contiguous(), k_pos.cuda().contiguous()))


def _c_block(dtype):
    """llama4-smoke's attention (4/2 heads, D 16) with chunk 16 on the card
    and on the CPU: params, spec, and a C ring (2 chunks) per device."""
    from repro_torch.configs import AttentionSpec
    from repro_torch.models import attention as attn

    spec = AttentionSpec(n_heads=4, n_kv_heads=2, d_head=16, chunk=16)
    g = torch.Generator().manual_seed(3)
    params = {n: torch.randn(*p.shape, generator=g) * 0.3
              for n, p in attn.attention_defs(64, spec).items()}
    shape = attn.cache_defs(4, 64, spec, "C")["k"].shape
    assert shape[2] == 32
    cache = {n: torch.randn(*shape, generator=g) for n in ("k", "v")}
    return {d: (tree_map(lambda t: t.to(d, dtype), params),
                {n: t.to(d, dtype) for n, t in cache.items()}) for d in ("cpu", "cuda")}, spec


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c_decode_runs_the_prefill_kernel_with_one_query(dtype):
    """A C layer's decode on the card launches the prefill kernel once
    (one query, masked by the positions the ring holds) and no decode
    kernel, in a CUDA graph too, and gives what it gives on the CPU; rows
    in the first chunk, at and past its end, past the ring's end."""
    from repro_torch.models import attention as attn

    blocks, spec = _c_block(dtype)
    lengths = torch.tensor([3, 16, 40, 77], dtype=torch.int32)
    x = torch.randn(4, 1, 64, generator=torch.Generator().manual_seed(4)).to(dtype)
    out = {}
    for d, (params, cache) in blocks.items():
        before = (flash_prefill.launches, flash_decode.launches)
        out[d] = attn.gqa_decode(params, x.to(d), cache, lengths.to(d), spec, "C")
        if d == "cuda":
            torch.cuda.synchronize()
            assert (flash_prefill.launches, flash_decode.launches) == (before[0] + 1,
                                                                       before[1])
    torch.testing.assert_close(out["cuda"].float().cpu(), out["cpu"].float(), **TOL[dtype])
    for n in ("k", "v"):
        torch.testing.assert_close(blocks["cuda"][1][n].float().cpu(),
                                   blocks["cpu"][1][n].float(), **TOL[dtype])
    # the same call captured and replayed
    params, cache = blocks["cuda"]
    xs, ls = x.cuda(), lengths.cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attn.gqa_decode(params, xs, cache, ls, spec, "C")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = attn.gqa_decode(params, xs, cache, ls, spec, "C")
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float().cpu(), out["cpu"].float(), **TOL[dtype])


@requires_cuda
def test_c_decode_kernel_at_llama4_widths_against_plain():
    """The prefill kernel with one query over a C ring of 2 x 8192 slots
    (llama4: 40/8 heads, D 128), bf16, lengths in the first chunk, at its
    end, in the second, at and past the ring's end: against the plain
    version on the same ring positions."""
    from repro_torch.models.attention import _ring_positions

    lens = torch.tensor([100, 8191, 8192, 8300, 12000, 16383, 16384, 20000],
                        dtype=torch.int32, device="cuda")
    B, size = 8, 16384
    q_pos = lens[:, None].contiguous()
    k_pos = _ring_positions(lens + 1, size)
    _bf16_prefill_matches_plain(B, 5, 8, 128, 1, size, 0, kind="chunked",
                                kw={"chunk": 8192}, positions=(q_pos, k_pos))


@requires_cuda
def test_gemma3_smoke_on_card_matches_cpu():
    """gemma3-27b-smoke (window 32) in float32 through Server on the card
    (CUDA graphs) and on the CPU, same weights, prompts of 40-90 tokens
    with chunk 8 (the L rings wrap): the same greedy tokens; a replay
    launches one attention kernel a layer."""
    from repro_torch.serve import Request, ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config("gemma3-27b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tb.cfg.vocab, n).astype(np.int32) for n in (40, 90, 55, 71)]
    tokens = {}
    for d in ("cpu", "cuda"):
        p = params if d == "cpu" else tree_map(lambda t: t.cuda(), params)
        server = Server(tb, ServeConfig(batch_slots=2, max_len=128, prefill_chunk=8), p,
                        device=d)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        server.add_requests(reqs)
        server.run_until_done(max_steps=500)
        tokens[d] = [r.out_tokens for r in reqs]
        if d == "cuda":
            L = tb.cfg.n_layers
            assert server.engine.graph_launches == {
                "decode": {"decode_attention": L}, "prefill": {"prefill_attention": L}}
    assert tokens["cuda"] == tokens["cpu"]


@requires_cuda
def test_realize_keeps_a_tree_already_on_the_card():
    """Realizing params or a cache that already lie on the card under
    ``hbm_resident`` hands back the same tensors: a model of 54 GB (gemma3)
    must not be copied on an 80 GB card, whether the runtime was given
    ``cuda`` or ``cuda:0``."""
    from repro_torch.api import Runtime
    from repro_torch.core.placement import Role

    tb = ModelBundle(dataclasses.replace(smoke_config("gemma3-27b"), dtype="float32"))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    for device in ("cuda", "cuda:0"):
        rt = Runtime(tb, device, "hbm_resident")
        assert rt.realize(params, Role.PARAMS) is params
        cache = tb.init_cache(2, 64, device=device)
        assert rt.realize(cache, Role.KV_CACHE) is cache


# ---------------------------------------------------------------------------
# the GShard MoE FFN and llama4-maverick-smoke
# ---------------------------------------------------------------------------

def _moe_case(dtype, E=8, K=2, cf=0.5, B=4, S=16, d=64, ff=96, seed=6):
    """An MoE layer's params and input on the CPU in ``dtype``, routed with
    clear margins: each token leans on one or two router directions
    (orthonormal columns), so the top-k is the same in bf16 and f32.  A
    capacity of 8 rows an expert for 64 tokens: some tokens drop."""
    from repro_torch.configs import MoESpec
    from repro_torch.models import moe as moe_mod

    spec = MoESpec(n_experts=E, top_k=K, d_ff_expert=ff, n_shared=1, capacity_factor=cf)
    g = torch.Generator().manual_seed(seed)
    params = tree_map(lambda p: torch.randn(*p.shape, generator=g) * p.shape[-2] ** -0.5,
                      moe_mod.moe_defs(d, spec))
    basis, _ = torch.linalg.qr(torch.randn(d, d, generator=g))
    params["router"] = basis[:, :E] * 4
    first = torch.randint(0, E, (B * S,), generator=g)
    second = (first + 1 + torch.randint(0, E - 1, (B * S,), generator=g)) % E
    x = (0.1 * torch.randn(B * S, d, generator=g) + 2 * basis[:, first].T
         + basis[:, second].T).reshape(B, S, d)
    return spec, tree_map(lambda t: t.to(dtype), params), x.to(dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_moe_in_a_cuda_graph_replays_as_eager(dtype):
    """``apply_moe`` captures (every shape static, no host read) and its
    replay, on new input written into the captured buffer, equals an eager
    call bit for bit."""
    from repro_torch.models import moe as moe_mod

    spec, params, x = _moe_case(dtype)
    params = tree_map(lambda t: t.cuda(), params)
    xs = x.cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_mod.apply_moe(params, xs, spec)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, aux = moe_mod.apply_moe(params, xs, spec)
    xs.copy_(torch.flip(x, [1]).cuda())
    graph.replay()
    want, want_aux = moe_mod.apply_moe(params, xs, spec)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


@requires_cuda
def test_apply_moe_bf16_on_card_matches_f32_on_cpu():
    """bf16 on the card against f32 on the CPU from the same (bf16-rounded)
    values: the same routing and drops, outputs within bf16's limit."""
    from repro_torch.models import moe as moe_mod

    spec, params, x = _moe_case(torch.bfloat16)
    got, aux = moe_mod.apply_moe(tree_map(lambda t: t.cuda(), params), x.cuda(), spec)
    want, want_aux = moe_mod.apply_moe(tree_map(lambda t: t.float(), params), x.float(), spec)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float().cpu(), want, atol=2e-2 * scale, rtol=2e-2)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-3, rtol=1e-3)


@requires_cuda
def test_llama4_smoke_on_card_matches_cpu():
    """llama4-maverick-smoke (CCCG, MoE on layers 1 and 3) in float32
    through Server on the card (CUDA graphs) and on the CPU, same weights,
    prompts within the chunk of 64 (chunk 4: dispatches drop tokens): the
    same greedy tokens; a decode replay launches the decode kernel for the
    G layer and the prefill kernel for the 3 C layers."""
    from repro_torch.serve import Request, ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config("llama4-maverick-400b-a17b"),
                                         dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tb.cfg.vocab, n).astype(np.int32) for n in (20, 9, 33, 4, 27)]
    tokens = {}
    for d in ("cpu", "cuda"):
        p = params if d == "cpu" else tree_map(lambda t: t.cuda(), params)
        server = Server(tb, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4), p,
                        device=d)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=12) for i, pr in enumerate(prompts)]
        server.add_requests(reqs)
        server.run_until_done(max_steps=500)
        tokens[d] = [r.out_tokens for r in reqs]
        if d == "cuda":
            assert server.engine.graph_launches == {
                "decode": {"decode_attention": 1, "prefill_attention": 3},
                "prefill": {"prefill_attention": 4}}
    assert tokens["cuda"] == tokens["cpu"]


# ---------------------------------------------------------------------------
# encoder-decoder and VLM (ROADMAP A7): cross-attention through the
# full-sequence kernel, bidirectional, Sq != Sk
# ---------------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk", [
    (2, 16, 1, 1024),       # seamless decode cross: one live row of the block
    (2, 16, 256, 1024),     # a prefill chunk's cross
    (1, 16, 1024, 1024),    # the encoder
    (1, 16, 37, 1000),      # ragged, off every tile
    (1, 16, 300, 64),       # Sq > Sk: the backward's row range over every row
])
def test_flash_attention_cross_shapes_match_plain(B, H, Sq, Sk, dtype):
    _attention_matches_plain(B, H, H, Sq, Sk, 64, 0, "bidirectional", {}, dtype, seed=70)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_one_query_replays_in_a_cuda_graph(dtype):
    """ops.attention with one query against 1024 memory positions (a decode
    step's cross-attention), captured in a CUDA graph: each replay over new
    queries equals the eager call bit for bit."""
    q = _randn(8, 16, 1, 64, dtype=dtype, seed=80)
    k = _randn(8, 16, 1024, 64, dtype=dtype, seed=81)
    v = _randn(8, 16, 1024, 64, dtype=dtype, seed=82)
    with torch.no_grad():
        out = ops.attention(q, k, v, kind="bidirectional")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.attention(q, k, v, kind="bidirectional")
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ops.attention(q, k, v, kind="bidirectional")
        for seed in (83, 84):
            q.copy_(_randn(8, 16, 1, 64, dtype=dtype, seed=seed))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, ops.attention(q, k, v, kind="bidirectional"))
    torch.testing.assert_close(out.float(), ref.attention(q, k, v, kind="bidirectional").float(),
                               **TOL[dtype])


def _a7_server_tokens(tb, params, device, prompts, bundle=None, new=6):
    from repro_torch.serve import Request, ServeConfig, Server

    p = params if device == "cpu" else tree_map(lambda t: t.cuda(), params)
    server = Server(bundle or tb, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4), p,
                    device=device)
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=new) for i, pr in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=1000)
    assert all(r.done for r in reqs)
    return server, [r.out_tokens for r in reqs]


@requires_cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_a7_smoke_served_on_card_matches_cpu(arch):
    """seamless-smoke and internvl2-smoke in float32 through Server on the
    card (CUDA graphs) and on the CPU, same weights: the same greedy
    tokens; an encoder-decoder replay launches per decoder layer one
    self-attention kernel and one cross-attention (flash_attention)."""
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tb.cfg.vocab, n).astype(np.int32) for n in (20, 9, 33, 4, 27)]
    _, want = _a7_server_tokens(tb, params, "cpu", prompts)
    server, got = _a7_server_tokens(tb, params, "cuda", prompts)
    L = tb.cfg.n_layers
    cross = {"flash_attention": L} if tb.encdec else {}
    assert server.engine.graph_launches == {
        "decode": {"decode_attention": L, **cross},
        "prefill": {"prefill_attention": L, **cross}}
    assert got == want


@requires_cuda
def test_replay_admission_on_card_replays_the_decode_graph():
    """A seamless-smoke bundle whose prefill_at raises: no prefill graph is
    captured, admission replays the decode graph, and the tokens equal
    chunked admission's on the card."""

    class NoChunk:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def prefill_at(self, *args, **kwargs):
            raise NotImplementedError

    tb = ModelBundle(dataclasses.replace(smoke_config("seamless-m4t-medium"),
                                         dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, tb.cfg.vocab, n).astype(np.int32) for n in (12, 5, 9)]
    _, want = _a7_server_tokens(tb, params, "cuda", prompts)
    server, got = _a7_server_tokens(tb, params, "cuda", prompts, bundle=NoChunk(tb))
    st = server.stats()
    assert got == want
    assert set(server.engine.graph_launches) == {"decode"}
    assert st["decode_replay_prefills"] == 3 and st["prefill_replays"] == 0
    assert st["decode_replays"] == st["decode_steps"] + sum(len(p) - 1 for p in prompts)


@requires_cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_a7_prefill_with_embeddings_on_card_matches_cpu(arch):
    """bundle.prefill with nonzero frame / patch embeddings, then 6 greedy
    decode steps, float32, card against CPU: logits close, tokens equal
    (the cross-attention reads a nonzero memory)."""
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    key = "frame_embeds" if tb.encdec else "patch_embeds"
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, tb.cfg.vocab, (3, 10), generator=g),
             key: torch.randn(3, tb.cfg.frontend_tokens, tb.cfg.d_model, generator=g)}
    start = 10 if tb.encdec else 10 + tb.cfg.frontend_tokens
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(d), params)
        cache = tb.init_cache(3, 64, device=d)
        with torch.no_grad():
            logits, _ = tb.prefill(p, {k: v.to(d) for k, v in batch.items()}, cache)
            toks, seq = torch.argmax(logits, -1), [logits.cpu()]
            for i in range(6):
                lengths = torch.full((3,), start + i, dtype=torch.int32, device=d)
                logits, _ = tb.decode_step(p, {"tokens": toks[:, None].to(torch.int32),
                                               "lengths": lengths}, cache)
                toks = torch.argmax(logits, -1)
                seq.append(logits.cpu())
        out[d] = seq
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        assert torch.equal(torch.argmax(a, -1), torch.argmax(b, -1))


@requires_cuda
def test_one_rank_compressed_grad_sync_on_card_is_an_identity(tmp_path):
    """A one-rank NCCL group and its (1,) ``pod`` mesh: ``compressed_grad_sync``
    returns the gradients and the error feedback themselves; ``quantize``
    on the card rounds every element to within half a step, and equals
    the CPU's bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.optim import compressed_grad_sync, dequantize, init_error_feedback, quantize

    g = torch.Generator(device="cuda").manual_seed(3)
    grads = {"w": torch.randn(64, 48, generator=g, device="cuda"),
             "b": torch.randn(61, generator=g, device="cuda").to(torch.bfloat16)}
    ef = init_error_feedback(grads)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        synced, new_ef = compressed_grad_sync(grads, ef, make_mesh_for((1,), ("pod",)))
    finally:
        dist.destroy_process_group()
    assert synced is grads and new_ef is ef
    for t in grads.values():
        q, s = quantize(t)
        assert q.device.type == "cuda" and q.dtype == torch.int8
        assert float((dequantize(q, s) - t.float()).abs().max()) <= float(s) * 0.5 + 1e-9
        qc, sc = quantize(t.cpu())
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)


@requires_cuda
def test_host_stream_in_reverse_waits_for_each_slot_reader():
    """A HostStream over pinned windows swept last first on the card: each
    window's values are right although the reader of a slot is slow (the
    refill of the slot, issued on the copy stream while the reader runs,
    waits for it), and the prefetch runs one window behind."""
    from repro_torch.core.placement import HostStream, to_host

    n, d = 6, 1024
    host = to_host({"w": torch.arange(1, n + 1, dtype=torch.float32)[:, None, None]
                    .expand(n, d, d).contiguous()}, "cuda")
    assert host["w"].is_pinned() and host["w"].device.type == "cpu"
    st = HostStream.stacked(host, n, "cuda")
    sums = {}
    st.begin(reverse=True)
    for i in reversed(range(n)):
        w = st.window(i)["w"]
        acc = torch.zeros((), device="cuda")
        for _ in range(20):                  # a slow reader of the slot
            acc = acc + (w @ w).mean()
        sums[i] = acc
    st.finish()
    torch.cuda.synchronize()
    for i in range(n):
        assert sums[i].item() == pytest.approx(20 * d * (i + 1) ** 2, rel=1e-6), i
    assert list(st.fetches) == list(reversed(range(n)))
    assert st._copy_stream != torch.cuda.current_stream()


@requires_cuda
@pytest.mark.parametrize("policy", ["weights_stream", "params=host"])
def test_params_in_host_memory_train_on_card_as_hbm_resident(policy):
    """olmo-1b-smoke in float32, 3 AdamW steps on the card under a params
    placement in host memory and under hbm_resident from the same weights:
    the same losses, grad norms and params, bit for bit; the host params
    keep their pinned storage; the attention kernels launch as often
    (forward twice a layer, backward once)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    tb = ModelBundle(dataclasses.replace(smoke_config("olmo-1b"), dtype="float32"))
    runs = {}
    for pol in ("hbm_resident", policy):
        tcfg = TrainConfig(remat="full", policy=pol,
                           optimizer=AdamWConfig(lr=1e-3, warmup_steps=2))
        params, opt, ef = init_train_state(
            tb, torch.Generator(device="cuda").manual_seed(0), tcfg)
        where = [t.data_ptr() for t in tree_leaves(params)]
        step = make_train_step(tb, tcfg)
        data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=64, global_batch=4))
        fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
        out = []
        for _ in range(3):
            batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
            params, opt, ef, m = step(params, opt, ef, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        torch.cuda.synchronize()
        launches = (flash_attention.launches - fwd, flash_attention_bwd.launches - bwd)
        runs[pol] = (out, [t.clone() for t in tree_leaves(params)], launches)
        if pol != "hbm_resident":
            assert [t.data_ptr() for t in tree_leaves(params)] == where
            assert all(t._host_arena.pinned for t in tree_leaves(params))
    L = tb.cfg.n_layers
    assert runs[policy][2] == runs["hbm_resident"][2] == (2 * L * 3, L * 3)
    assert runs[policy][0] == runs["hbm_resident"][0]
    for a, b in zip(runs[policy][1], runs["hbm_resident"][1]):
        assert torch.equal(a.cuda(), b)


@requires_cuda
def test_seamless_kv_host_server_on_card_as_hbm_resident():
    """seamless-smoke in float32 served on the card through the graphs
    under kv_host and hbm_resident, over the same random cross KV: the same
    greedy tokens; a decode replay writes back each layer's self rows (one
    kv_stream launch a layer) and the host cross KV is unchanged."""
    from repro_torch.serve import Request, ServeConfig, Server

    tb = ModelBundle(dataclasses.replace(smoke_config("seamless-m4t-medium"),
                                         dtype="float32"))
    params = tree_map(lambda t: t.cuda(), tb.init_params(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tb.cfg.vocab, n).astype(np.int32) for n in (20, 9, 33, 4)]
    runs = {}
    for pol in ("hbm_resident", "kv_host"):
        server = Server(tb, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4,
                                        policy=pol), params, device="cuda")
        cross = tree_leaves(server.engine.caches["decoder"]["cross"])
        gen = torch.Generator().manual_seed(3)
        for t in cross:
            t.copy_(torch.randn(t.shape, generator=gen))
        before = [t.clone() for t in cross]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        server.add_requests(reqs)
        server.run_until_done(max_steps=1000)
        torch.cuda.synchronize()
        runs[pol] = [r.out_tokens for r in reqs]
        if pol == "kv_host":
            assert all(t.device.type == "cpu" and t.is_pinned() for t in cross)
            assert all(torch.equal(a, b) for a, b in zip(before, cross))
            assert server.engine.graph_launches["decode"]["kv_stream"] == tb.cfg.n_layers
            assert server.stats()["decode_replays"] > 0
    assert runs["kv_host"] == runs["hbm_resident"]
