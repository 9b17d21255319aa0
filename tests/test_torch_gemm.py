"""The GEMM study's kernel module against the JAX reference, on the CPU.

``ref.matmul`` (the plain version the CUDA ``blocked_matmul`` is held to on
the card) against the reference's Pallas ``blocked_matmul`` in interpret
mode, with ``tests/test_kernels.py::test_blocked_matmul``'s shapes and
tolerances, and against the reference's own oracle; the traffic model's
bytes and flops against the reference's bit for bit; ``best_tiling``'s
properties under the 227 KB shared-memory budget; and the CPU routing and
refusals of the wrapper, which need no card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import blocked_matmul as rbm
from repro.kernels import ref as rref
from repro_torch.kernels import blocked_matmul as pbm
from repro_torch.kernels import ops, ref

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(M, N, K, dtype, seed):
    """The same values on both sides: f32 numpy draws, cast once per side
    (bf16 casts of the same f32 values agree)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jd), jnp.asarray(b, jd),
            torch.from_numpy(a).to(td), torch.from_numpy(b).to(td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K,bm,bn,bk", [
    (256, 128, 512, 128, 128, 128),
    (128, 128, 128, 128, 128, 128),
    (512, 256, 256, 256, 128, 256),
])
def test_plain_matmul_matches_pallas_interpret(M, N, K, bm, bn, bk, dtype):
    ja, jb, ta, tb = _inputs(M, N, K, dtype, seed=5)
    want = rbm.blocked_matmul(ja, jb, bm=bm, bn=bn, bk=bk, out_dtype=jnp.float32)
    got = ref.matmul(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    tol = dict(atol=1.5, rtol=2e-2) if dtype == "bfloat16" else dict(
        atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", [None, "float32"])
@pytest.mark.parametrize("M,N,K", [(64, 48, 32), (256, 128, 512)])
def test_plain_matmul_matches_reference_oracle(M, N, K, dtype, out):
    """f32 sums in another order: 1e-5 relative plus 1e-4 absolute on
    outputs of |x| ~ sqrt(K); a bf16 output may differ by one bf16 ulp
    (2^-7 relative) where the f32 sums round to neighbouring values."""
    ja, jb, ta, tb = _inputs(M, N, K, dtype, seed=6)
    want = rref.matmul(ja, jb, out_dtype=None if out is None else jnp.float32)
    got = ref.matmul(ta, tb, out_dtype=None if out is None else torch.float32)
    assert str(got.dtype) == f"torch.{out or dtype}"
    assert str(want.dtype) == (out or dtype)
    rtol = 2.0 ** -7 if (out is None and dtype == "bfloat16") else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-4, rtol=rtol)


GRID = list(itertools.product(
    [(128, 128, 128), (1024, 1024, 1024), (4096, 2048, 512), (16384, 16384, 16384)],
    [(128, 128, 32), (128, 128, 128), (256, 128, 64), (256, 256, 512), (128, 512, 256)],
    [1, 2, 4],
))


@pytest.mark.parametrize("shape,tiling,itemsize", GRID,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_traffic_model_bytes_equal_reference(shape, tiling, itemsize):
    M, N, K = shape
    bm, bn, bk = tiling
    r = rbm.traffic_model(M, N, K, bm, bn, bk, itemsize)
    p = pbm.traffic_model(M, N, K, bm, bn, bk, itemsize)
    for key in ("hbm_bytes", "flops", "arithmetic_intensity"):
        assert p[key] == r[key], key
    # the CUDA kernel's footprint.  bf16: a ring of up to 4 stages of
    # unpadded A and B tiles with two 8-byte mbarriers each, plus 1024 B of
    # alignment; otherwise one A and one B tile, rows padded by 16 B
    if itemsize == 2:
        stage = (bm * bk + bk * bn) * 2 + 16
        stages = max(1, min(4, (232_448 - 1024) // stage))
        assert p["smem_bytes"] == 1024 + stages * stage
    else:
        assert p["smem_bytes"] == (bm * bk + bk * bn) * itemsize + 16 * (bm + bk)


@pytest.mark.parametrize("tiling,stages", [
    ((128, 128, 32), 4), ((128, 128, 64), 4), ((128, 128, 128), 3),
    ((256, 128, 32), 4), ((256, 128, 64), 4), ((256, 128, 128), 2),
    ((256, 128, 256), 1),
])
def test_bf16_ring_depth_per_tiling(tiling, stages):
    """The bf16 kernel's ring holds the most stages (at most 4) whose tiles
    fit 227 KB: (256, 128, 256)'s 192 KiB of tiles fit once.  Every bf16
    tiling fits; in f32, (256, 128, 256) does not."""
    assert pbm.ring_stages(*tiling) == stages
    smem = pbm.traffic_model(*tiling, *tiling, itemsize=2)["smem_bytes"]
    assert smem <= pbm.SMEM_BUDGET
    assert pbm.supported(*tiling, 2)
    assert pbm.supported(*tiling, 4) == (tiling != (256, 128, 256))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (16384, 16384, 16384),
                                   (512, 256, 512), (256, 128, 1024)])
def test_best_tiling_divides_fits_and_beats_128(shape, itemsize):
    M, N, K = shape
    bm, bn, bk = pbm.best_tiling(M, N, K, itemsize=itemsize)
    assert M % bm == 0 and N % bn == 0 and K % bk == 0
    assert (bm, bn, bk) in pbm.TILINGS and pbm.supported(bm, bn, bk, itemsize)
    big = pbm.traffic_model(M, N, K, bm, bn, bk, itemsize)
    small = pbm.traffic_model(M, N, K, 128, 128, 128, itemsize)
    assert big["smem_bytes"] <= pbm.SMEM_BUDGET == 232_448
    assert big["arithmetic_intensity"] >= small["arithmetic_intensity"]
    if M >= 256:
        assert big["arithmetic_intensity"] > small["arithmetic_intensity"]


def test_tiling_budget_and_default():
    # the reference's default and its VMEM-sized picks do not fit a block
    ref_default = (rbm.DEFAULT_BM, rbm.DEFAULT_BN, rbm.DEFAULT_BK)
    assert pbm.traffic_model(4096, 4096, 4096, *ref_default)["smem_bytes"] > 232_448
    assert not pbm.supported(*rbm.best_tiling(4096, 4096, 4096), 2)
    default = (pbm.DEFAULT_BM, pbm.DEFAULT_BN, pbm.DEFAULT_BK)
    assert default == pbm.best_tiling(16384, 16384, 16384)
    assert pbm.supported(*default, 2) and pbm.supported(*default, 4)
    assert not pbm.supported(256, 128, 256, 4)    # 401 KB of f32 tiles
    assert pbm.supported(256, 128, 256, 2)        # 200 KB of bf16 tiles
    with pytest.raises(ValueError, match="no tiling"):
        pbm.best_tiling(100, 128, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_matmul_on_cpu_is_the_plain_version(dtype):
    _, _, a, b = _inputs(256, 128, 512, "float32", seed=7)
    a, b = a.to(dtype), b.to(dtype)
    before = pbm.blocked_matmul.launches
    for out in (None, torch.float32):
        got = ops.matmul(a, b, out_dtype=out, bm=128, bn=128, bk=128)
        assert torch.equal(got, ref.matmul(a, b, out_dtype=out))
    assert pbm.blocked_matmul.launches == before


def test_wrapper_refuses_cpu_tensors_and_missing_tilings():
    a, b = torch.zeros(512, 256), torch.zeros(256, 256)
    with pytest.raises(ValueError, match="CUDA"):
        pbm.blocked_matmul(a, b, bm=128, bn=128, bk=128)
    with pytest.raises(ValueError, match="no instantiation"):
        pbm.blocked_matmul(a, b, bm=64, bn=64, bk=64)
    with pytest.raises(ValueError, match="no instantiation"):
        pbm.blocked_matmul(a, b, bm=256, bn=128, bk=256)     # f32: over 227 KB
    with pytest.raises(ValueError, match="not a multiple"):
        pbm.blocked_matmul(a[:384], b, bm=256)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        pbm.blocked_matmul(a, b.T[:100])
