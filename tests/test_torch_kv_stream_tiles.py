"""The KV write-back kernel's work partition, on the CPU.

``write_back_stores`` mirrors how ``csrc/kv_stream.cu`` hands the
surviving 16-byte chunks of a launch to its threads (a flat index over
row, keys then values, head, position and chunk; a grid-stride loop over
``write_back_blocks`` blocks).  Applied to a slab, its stores must give
exactly what ``ref.kv_write_back`` gives, for ragged rows, rows that
write nothing, rows longer than the ring and rows that wrap at ``S``:
every surviving chunk stored once, nothing else touched.  The kernel
itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import kv_stream, ref

#: float32 values in one 16-byte chunk
PER_CHUNK = kv_stream.CHUNK_BYTES // 4


def _apply(stores, src, dst):
    """``dst`` after the stores, chunk by chunk; ``src``/``dst`` are
    (2, B, H, S, D) float32 arrays (keys, values)."""
    out = dst.copy()
    s = src.reshape(*src.shape[:-1], -1, PER_CHUNK)
    o = out.reshape(s.shape)
    idx = (stores["kv"], stores["b"], stores["h"], stores["slot"], stores["chunk"])
    o[idx] = s[idx]
    return out


def _check(B, H, S, chunks, pos, n, blocks, seed=0):
    rng = np.random.default_rng(seed)
    D = chunks * PER_CHUNK
    src = rng.standard_normal((2, B, H, S, D)).astype(np.float32)
    dst = rng.standard_normal((2, B, H, S, D)).astype(np.float32)
    stores = kv_stream.write_back_stores(pos, n, H, S, chunks, blocks)
    got = _apply(stores, src, dst)
    want = [torch.from_numpy(d.copy()) for d in dst]
    t = [torch.from_numpy(x) for x in src]
    ref.kv_write_back(t[0], t[1], want[0], want[1], torch.tensor(pos, dtype=torch.int32),
                      torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(got, np.stack([w.numpy() for w in want]))
    # every surviving chunk exactly once, nothing else
    where = np.stack([stores[k] for k in ("kv", "b", "h", "slot", "chunk")], 1)
    assert len(np.unique(where, axis=0)) == len(where)
    survive = sum(min(max(x, 0), S) for x in n)
    assert len(where) == 2 * H * survive * chunks
    # each thread of the grid, in each step of its loop, stores one chunk:
    # consecutive lanes of a warp take consecutive flat indices
    thread = (stores["block"] * kv_stream.THREADS + stores["warp"] * 32 + stores["lane"])
    g = stores["step"] * blocks * kv_stream.THREADS + thread
    np.testing.assert_array_equal(g, np.arange(len(g)))
    assert stores["block"].max(initial=0) < blocks
    return stores


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 6), H=st.integers(1, 4), S=st.integers(1, 40),
       chunks=st.integers(1, 5), blocks=st.integers(1, 3), data=st.data())
def test_stores_equal_the_plain_write_back(B, H, S, chunks, blocks, data):
    pos = data.draw(st.lists(st.integers(-3 * S, 4 * S), min_size=B, max_size=B))
    n = data.draw(st.lists(st.one_of(st.just(0), st.integers(-2, S + 3),
                                     st.integers(S, 3 * S)), min_size=B, max_size=B))
    _check(B, H, S, chunks, pos, n, blocks)


@pytest.mark.parametrize("pos,n", [
    ([0, 7, 100, 2047, 1500, 64, 9, 2046], [1] * 8),                        # decode
    ([0, 256, 1800, 1900, 5, 0, 2047, 30], [256, 0, 256, 200, 13, 0, 256, 1]),  # wrap
    ([3, 1000, 2040, 17, 0, 0, 500, 1024], [100, 256, 9, 0, 2048, 0, 256, 2100]),
    ([5] * 8, [0] * 8),                                                     # no work
])
def test_stores_at_the_yi_serving_shape(pos, n):
    """yi-6b's decode and prefill row sets (8 rows, 4 KV heads, 2048 slots,
    D 128 bf16: 16 chunks a position) on the grid the wrapper sizes."""
    B, H, S, chunks = 8, 4, 2048, 16
    blocks = kv_stream.write_back_blocks(B * S * 2 * H * chunks, sms=132)
    rows = [0, 1, 7] if max(n) > 1 else list(range(B))       # keep it small on the CPU
    _check(len(rows), H, S, chunks, [pos[r] for r in rows], [n[r] for r in rows], blocks)


@pytest.mark.parametrize("n", [0, 1, 5, 40, 100])
def test_one_count_for_every_row(n):
    """Every row writing the same count (a decode step's 1, a full prefill
    chunk) goes through the same table as ragged rows: row b's chunks
    start at b x 2 H W C, on one block or several."""
    pos = [0, 39, 17, -3, 80]
    W = min(n, 40)
    for blocks in (1, 2):
        stores = _check(5, 2, 40, 3, pos, [n] * 5, blocks)
        starts = np.searchsorted(stores["b"], np.arange(5))
        np.testing.assert_array_equal(starts, np.arange(5) * 2 * 2 * W * 3)


def test_grid_is_sized_to_the_work():
    """One block for every THREADS chunks, at most one for every
    SMS_PER_BLOCK SMs, at least one.  The wrapper sizes it from the slab
    (the counts stay on the card): 8 blocks at yi-6b's serving shape on an
    H100's 132 SMs, whose first 4 a decode step's 1024 chunks fill (8 rows
    x 4 heads x 2 x 16 chunks): every lane busy, a warp two whole rows."""
    sms = 132
    assert kv_stream.write_back_blocks(8 * 1 * 2 * 4 * 16, sms) == 4
    assert kv_stream.write_back_blocks(8 * 256 * 2 * 4 * 16, sms) == sms // kv_stream.SMS_PER_BLOCK
    assert kv_stream.write_back_blocks(8 * 256 * 2 * 4 * 16, 3) == 1
    assert kv_stream.write_back_blocks(0, sms) == 1
    blocks = kv_stream.write_back_blocks(8 * 2048 * 2 * 4 * 16, sms)
    assert blocks == 8
    stores = kv_stream.write_back_stores([0, 7, 100, 2047, 1500, 64, 9, 2046], [1] * 8,
                                         4, 2048, 16, blocks)
    assert len(stores["lane"]) == 4 * kv_stream.THREADS
    assert set(stores["block"]) == {0, 1, 2, 3} and set(stores["step"]) == {0}
    first = (stores["lane"] < 16)
    assert np.all(np.diff(stores["chunk"][first].reshape(-1, 16), axis=1) == 1)
    half = stores["warp"] * 2 + (stores["lane"] >= 16) + 16 * stores["block"]
    for key in ("kv", "b", "h", "slot"):
        assert all(len(set(stores[key][half == w])) == 1 for w in np.unique(half))
