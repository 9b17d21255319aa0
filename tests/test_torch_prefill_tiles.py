"""The bf16 prefill kernel's tile classification, on the CPU.

``prefill_tile_class`` mirrors how ``csrc/prefill_attention.cu`` sorts each
(query rows, key tile) pair: "empty" pairs are skipped (and a tile empty
for a whole block is never loaded), "full" pairs are multiplied with no
per-element mask.  Both verdicts must be provable: an empty tile has no
live pair and a full tile only live pairs under the mask of
``ref.prefill_attention`` (``ref.prefill_mask``), for ordered cache
positions, ring-wrapped ones from ``_ring_positions``, holes anywhere, and
the sliding and chunked masks.  The kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    prefill_row_interval,
    prefill_tile_class,
)
from repro_torch.models.attention import _ring_positions

MASKS = [("causal", 0, 0), ("sliding", 1, 0), ("sliding", 7, 0),
         ("sliding", 40, 0), ("sliding", 0, 0), ("chunked", 0, 1),
         ("chunked", 0, 8), ("chunked", 0, 24)]


def _positions(layout, Sq, Sc, seed):
    """q_pos (Sq,) and k_pos (Sc + Sq,) of one batch row as the serving
    path builds them (a chunk of Sq queries at a cache fill, the chunk's
    own keys after the cache), with holes punched anywhere."""
    rng = np.random.default_rng(seed)
    off = int(rng.integers(0, 3 * Sc + 2))
    q = off + np.arange(Sq)
    if layout == "ordered":
        r = np.arange(Sc)
        cache = np.where(r < off, r, -1)
    elif layout == "ring":
        cache = _ring_positions(torch.tensor([off], dtype=torch.int32), Sc)[0].numpy()
    else:                                     # any positions, any order
        q = rng.integers(-3, 3 * Sc + Sq + 4, Sq)
        cache = rng.integers(-3, 3 * Sc + Sq + 4, Sc)
    new_len = int(rng.integers(0, Sq + 1))
    new = np.where(np.arange(Sq) < new_len, q, -1)
    k = np.concatenate([cache, new]).astype(np.int64)
    holes = rng.random(k.shape) < rng.choice([0.0, 0.05, 0.3])
    k[holes] = -1
    return q.astype(np.int64), k


@settings(max_examples=200, deadline=None)
@given(layout=st.sampled_from(["ordered", "ring", "any"]),
       mask=st.sampled_from(MASKS),
       Sq=st.integers(1, 40), Sc=st.integers(0, 150),
       seed=st.integers(0, 2**31 - 1))
def test_empty_and_full_tiles_are_provable(layout, mask, Sq, Sc, seed):
    """Every tiling of the (Sq, Sk) grid into row tiles of 8, 16 (a warp) or
    128 (a block) and key tiles of 8 or 64 (the kernel's)."""
    kind, window, chunk = mask
    q_pos, k_pos = _positions(layout, Sq, Sc, seed)
    Sk = len(k_pos)
    live = ref.prefill_mask(torch.from_numpy(q_pos)[None], torch.from_numpy(k_pos)[None],
                            kind=kind, window=window, chunk=chunk)[0].numpy()
    tiles = ((r, c, i, j) for r in (8, 16, 128) for c in (8, 64)
             for i in range(0, Sq, r) for j in range(0, Sk, c))
    for rows, cols, i0, j0 in tiles:
        got = prefill_tile_class(q_pos, k_pos, kind, window, chunk,
                                 range(i0, i0 + rows), range(j0, j0 + cols))
        tile = live[i0:i0 + rows, j0:j0 + cols]
        if got == "empty":
            assert not tile.any(), (i0, j0)
        elif got == "full":
            # rows past Sq and keys past Sk are never live: a full tile
            # lies wholly inside the (Sq, Sk) grid
            assert i0 + rows <= Sq and j0 + cols <= Sk, (i0, j0)
            assert tile.all(), (i0, j0)
        else:
            assert got == "partial"


@given(qp=st.integers(-5, 300), mask=st.sampled_from(MASKS),
       kp=st.integers(-5, 300))
def test_row_interval_is_the_mask(qp, mask, kp):
    """A key is live for a row exactly when its position lies in the row's
    interval: the kernel's per-element test."""
    kind, window, chunk = mask
    lo, hi = prefill_row_interval(qp, kind, window, chunk)
    want = bool(ref.prefill_mask(torch.tensor([[qp]]), torch.tensor([[kp]]),
                                 kind=kind, window=window, chunk=chunk)[0, 0, 0])
    assert (lo <= kp <= hi) == want


def test_main_path_tiles_are_mostly_not_partial():
    """A 256-token chunk at cache fill 1000 against a 2048-slot cache:
    cache tiles below the fill are full, tiles past it empty, and the
    chunk's own tiles partial only on the diagonal (16-query warps against
    64-key tiles)."""
    Sc, Sq, off = 2048, 256, 1000
    r = np.arange(Sc)
    q_pos = off + np.arange(Sq)
    k_pos = np.concatenate([np.where(r < off, r, -1), q_pos])
    counts = {"empty": 0, "full": 0, "partial": 0}
    for i0 in range(0, Sq, 16):
        for j0 in range(0, Sc + Sq, 64):
            c = prefill_tile_class(q_pos, k_pos, rows=range(i0, i0 + 16),
                                   cols=range(j0, j0 + 64))
            counts[c] += 1
            if j0 + 64 <= off:
                assert c == "full"
            elif off < j0 < Sc:
                assert c == "empty"
            elif j0 >= Sc and j0 - Sc > i0 + 15:
                assert c == "empty"
    # per warp: 15 full cache tiles, one partial across the fill, 16 empty
    # ones past it; of the chunk's 4 tiles, those below the warp's diagonal
    # full (0-3, 24 over the 16 warps), the diagonal partial, the rest empty
    assert counts == {"empty": 16 * 16 + 24, "full": 16 * 15 + 24, "partial": 16 * 2}


def test_sliding_window_tiles():
    """A window reaches back only so far: tiles wholly before it are empty,
    tiles wholly inside it full."""
    q_pos = np.arange(512, 528)
    k_pos = np.arange(0, 528)
    cls = [prefill_tile_class(q_pos, k_pos, "sliding", 256, 0, range(16),
                              range(j0, j0 + 64)) for j0 in range(0, 528, 64)]
    assert cls[:4] == ["empty"] * 4
    assert cls[4] == "partial" and cls[5:8] == ["full"] * 3
    assert cls[8] == "partial"
