"""The port's training attention on the CPU vs the JAX reference's.

On a CPU tensor ``repro_torch.kernels.ops.attention`` takes the plain
PyTorch versions (``ref.attention``, and ``ref.attention_chunked`` from
``Sq >= 2048``), and autograd differentiates them.  They are held to the
reference's oracles (backend ``"ref"``) on the same numpy inputs with the
tolerances of ``tests/test_kernels.py``; their gradients to ``jax.grad``
of the reference.  The CUDA forward and backward kernels are held to
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

#: tests/test_kernels.py's attention tolerances
TOL = {"bfloat16": dict(atol=5e-2, rtol=5e-2), "float32": dict(atol=3e-5, rtol=1e-5)}

MASKS = [
    ("causal", {}),
    ("sliding", {"window": 64}),
    ("chunked", {"chunk": 128}),
    ("bidirectional", {}),
]


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _pair(x: np.ndarray, name: str):
    """The same values in both frameworks (bf16 rounds identically)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D,q_offset",
    [
        (1, 4, 4, 128, 128, 32, 0),       # G = 1 (olmo)
        (2, 8, 2, 256, 256, 64, 0),       # G = 4
        (1, 8, 1, 96, 320, 16, 224),      # G = 8 (yi smoke), queries at the end
    ],
)
@pytest.mark.parametrize("kind,kw", MASKS)
def test_attention_matches_reference(B, Hq, Hkv, Sq, Sk, D, q_offset, kind, kw,
                                     dtype):
    arrs = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=Sq + Hq + D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    want = jref.attention(jq, jk, jv, kind=kind, q_offset=q_offset, **kw)
    got = tops.attention(tq, tk, tv, kind=kind, q_offset=q_offset, **kw)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,kw", MASKS)
def test_attention_chunked_matches_reference(kind, kw, dtype):
    """Query blocks of 64 over 256 queries, GQA, q_offset: the same
    numbers as the reference's chunked evaluator and as one block."""
    arrs = _inputs(1, 4, 2, 256, 320, 32, seed=5)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    mask = dict(kind=kind, q_offset=64, **kw)
    want = jref.attention_chunked(jq, jk, jv, block_q=64, **mask)
    got = tref.attention_chunked(tq, tk, tv, block_q=64, **mask)
    _close(got, want, **TOL[dtype])
    whole = tref.attention(tq, tk, tv, **mask)
    _close(got, whole.float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("kind,kw", [("causal", {}), ("sliding", {"window": 300})])
def test_long_sequences_take_the_chunked_path(kind, kw):
    """At Sq >= 2048 both dispatches evaluate block by block: same values,
    and the port's gradient through its checkpointed blocks matches."""
    arrs = _inputs(1, 2, 1, 2048, 2048, 16, seed=9)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrs)
    want = jops.attention(jq, jk, jv, kind=kind, backend="ref", **kw)
    got = tops.attention(tq, tk, tv, kind=kind, **kw)
    _close(got, want, **TOL["float32"])
    assert "Cat" in got.grad_fn.name()          # joined from query blocks
    g = np.random.default_rng(1).normal(size=got.shape).astype(np.float32)
    jg = jax.grad(lambda q: jnp.sum(
        jops.attention(q, jk, jv, kind=kind, backend="ref", **kw) * g))(jq)
    (tg,) = torch.autograd.grad(got, (tq,), torch.from_numpy(g))
    _close(tg, jg, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D,q_offset",
    [(1, 4, 4, 128, 128, 32, 0), (2, 8, 2, 64, 160, 16, 96)],
)
@pytest.mark.parametrize("kind,kw", MASKS)
def test_attention_grads_match_reference(B, Hq, Hkv, Sq, Sk, D, q_offset, kind, kw):
    """dq, dk, dv of ops.attention against jax.grad of the reference, at
    tests/test_kernels.py's gradient tolerance; dk/dv sum over the query
    heads of each KV head (GQA)."""
    arrs = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=11)
    mask = dict(kind=kind, q_offset=q_offset, **kw)

    def jloss(q, k, v):
        return jnp.sum(jops.attention(q, k, v, backend="ref", **mask) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrs)
    loss = torch.sum(tops.attention(tq, tk, tv, **mask) ** 2)
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)


def test_attention_on_cpu_never_builds_a_kernel():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    before = (flash_attention.launches, flash_attention_bwd.launches)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    tops.attention(q, q, q).sum().backward()
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    assert "flash_attention" not in _build._LIBS
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.detach(), q.detach(), q.detach())


@pytest.mark.parametrize("d,fwd,bwd_dq,bwd_dkdv", [
    # rows x (d + 8) x 2 bytes; the dK/dV kernel adds 2 stages x 2 x 32 f32
    (16, 384 * 48, 256 * 48, 256 * 48 + 512),
    (32, 384 * 80, 256 * 80, 256 * 80 + 512),
    (64, 384 * 144, 256 * 144, 256 * 144 + 512),
    (128, 384 * 272, 256 * 272, 256 * 272 + 512),
])
def test_smem_footprint_bytes(d, fwd, bwd_dq, bwd_dkdv):
    """The bf16 kernels' shared memory per head dim (the C side's numbers are
    held to these on the card): every kernel fits a block's 227 KB, and two
    forward blocks (plus 1 KB each that the SM reserves) fit one SM's 228 KB
    at every head dim."""
    from repro_torch.kernels.blocked_matmul import SMEM_BUDGET
    from repro_torch.kernels.flash_attention import smem_footprint_bytes

    got = smem_footprint_bytes(d)
    assert got == {"fwd": fwd, "bwd_dq": bwd_dq, "bwd_dkdv": bwd_dkdv}
    assert max(got.values()) <= SMEM_BUDGET == 232_448
    assert 2 * (got["fwd"] + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="head dim"):
        smem_footprint_bytes(d + 8)
