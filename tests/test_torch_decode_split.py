"""The host-side launch plans of the decode and SSD scan kernels, on the CPU.

``num_splits`` picks how many blocks (one thread-block cluster) share a
(row, KV head) of ``csrc/decode_attention.cu``, and ``split_ranges``
mirrors how each block of the cluster cuts its row's live keys
(``split_tiles`` in the source).  ``heads_per_block`` picks how many heads
a block of the bf16 ``csrc/ssd_scan.cu`` kernel carries.  The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_split.py
"""

import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ssd_scan as scan

#: the most dynamic shared memory one block may use on an H100 (227 KB)
SMEM_MAX = 232448
GRID_MAX = 65535

SMS = st.sampled_from([1, 2, 16, 66, 114, 132, 144])
TILES = st.sampled_from(sorted(dec.KEY_TILE.values()))


@st.composite
def decode_plans(draw):
    B = draw(st.integers(1, 12))
    Hkv = draw(st.integers(1, 16))
    Smax = draw(st.integers(1, 4096))
    lengths = draw(st.lists(st.integers(-5, Smax + 70), min_size=B, max_size=B))
    return B, Hkv, Smax, lengths, draw(TILES), draw(SMS)


@settings(max_examples=300, deadline=None)
@given(decode_plans())
def test_every_live_key_falls_in_exactly_one_split(plan):
    B, Hkv, Smax, lengths, tile, sms = plan
    ns = dec.num_splits(B, Hkv, Smax, tile, sms)
    for length in lengths:
        live = min(max(length, 0), Smax)
        ranges = dec.split_ranges(length, Smax, ns, tile)
        assert len(ranges) == ns
        hits = torch.zeros(Smax + tile, dtype=torch.int32)
        for lo, hi in ranges:
            assert 0 <= lo <= hi <= live <= Smax     # no split reaches past Smax
            assert lo % tile == 0 or lo == live       # whole tiles from the start
            hits[lo:hi] += 1
        assert torch.all(hits[:live] == 1)
        assert torch.all(hits[live:] == 0)


@settings(max_examples=300, deadline=None)
@given(decode_plans())
def test_split_count_fits_the_grid_and_the_cluster(plan):
    B, Hkv, Smax, _, tile, sms = plan
    ns = dec.num_splits(B, Hkv, Smax, tile, sms)
    assert 1 <= ns <= dec.MAX_SPLITS <= GRID_MAX     # grid x, one portable cluster
    assert ns <= -(-Smax // tile)                    # at most one tile each
    # enough blocks for two an SM unless the cluster or Smax caps them
    if ns < min(dec.MAX_SPLITS, -(-Smax // tile)):
        assert B * Hkv * ns >= 2 * sms


@settings(max_examples=200, deadline=None)
@given(decode_plans())
def test_splits_of_a_row_differ_by_at_most_one_tile(plan):
    B, Hkv, Smax, lengths, tile, sms = plan
    ns = dec.num_splits(B, Hkv, Smax, tile, sms)
    for length in lengths:
        tiles = [-(-(hi - lo) // tile) for lo, hi in dec.split_ranges(length, Smax, ns, tile)]
        assert max(tiles) - min(tiles) <= 1


def test_decode_plan_at_the_serving_shape():
    """yi-6b: 8 rows x 4 KV heads on 132 SMs take the full cluster of 8, and
    a row of 650 live keys spreads its 11 tiles over all 8 blocks."""
    assert dec.num_splits(8, 4, 2048, dec.KEY_TILE[torch.bfloat16], 132) == 8
    ranges = dec.split_ranges(650, 2048, 8, 64)
    assert ranges[0] == (0, 64) and ranges[-1] == (576, 650)
    assert all(hi > lo for lo, hi in ranges)
    assert dec.split_ranges(0, 2048, 8, 64) == [(0, 0)] * 8
    assert dec.split_ranges(9000, 2048, 8, 64)[-1][1] == 2048


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 64), st.integers(1, 128), st.sampled_from(scan.SUPPORTED_P), SMS)
def test_heads_per_block_covers_every_head_in_one_wave_when_it_can(B, H, P, sms):
    hb = scan.heads_per_block(B, H, P, sms)
    hb_max = min(scan.MAX_WARPS // (P // 16), H)
    assert 1 <= hb <= max(hb_max, 1)
    assert hb * (P // 16) <= scan.MAX_WARPS            # the kernel's launch bound
    blocks = -(-H // hb)
    heads = [h for blk in range(blocks) for h in range(blk * hb, min(blk * hb + hb, H))]
    assert heads == list(range(H))                     # each head in exactly one block
    assert B <= GRID_MAX and blocks <= GRID_MAX
    # the fewest heads a block for which the grid fits the SMs at once
    if B * blocks <= sms:
        assert hb == 1 or B * -(-H // (hb - 1)) > sms
    else:
        assert hb == hb_max


def test_heads_per_block_at_the_serving_shapes():
    """mamba2-780m (8 rows x 48 heads of P 64) on 132 SMs: 3 heads a block,
    128 blocks in one wave; zamba2-1.2b's 64 heads cannot fit one wave
    and take the most a block holds (3)."""
    assert scan.heads_per_block(8, 48, 64, 132) == 3
    assert scan.heads_per_block(8, 64, 64, 132) == 3
    assert scan.heads_per_block(2, 4, 32, 132) == 1


def test_kernels_shared_memory_fits_the_card():
    """The decode kernel's ring fits three blocks an SM (228 KB an SM, 1 KB
    reserved a block); the scan's stages fit one block at every heads a
    block it can be given."""
    for D in dec.SUPPORTED_D:
        assert 3 * (dec.smem_bytes(D) + 1024) <= 233472
    for P in scan.SUPPORTED_P:
        for N in scan.SUPPORTED_N:
            for hb in range(1, scan.MAX_WARPS // (P // 16) + 1):
                assert scan.smem_bytes(P, N, hb) <= SMEM_MAX
