"""The port's attention ops on the CPU vs the JAX reference's.

On a CPU tensor ``repro_torch.kernels.ops`` takes the plain PyTorch
versions; they are held to the reference's Pallas kernels (interpret mode)
and its jnp oracles on the same numpy inputs, with the tolerances of
``tests/test_kernels.py``.  The CUDA kernels themselves are held to these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_prefill

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else dict(
        atol=3e-5, rtol=1e-5
    )


def _pair(x: np.ndarray, name: str):
    """The same values in both frameworks (bf16 rounds identically)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,D,Smax,lengths",
    [
        (3, 4, 4, 16, 64, [1, 33, 64]),          # G = 1 (olmo)
        (2, 8, 1, 16, 64, [1, 63]),              # G = 8 (yi smoke)
        (2, 16, 2, 32, 512, [1, 300]),           # G = 8, long cache
        (2, 4, 4, 16, 512, [512, 7]),            # G = 1, full and ragged
    ],
)
def test_decode_matches_reference(B, Hq, Hkv, D, Smax, lengths, dtype, backend):
    rng = np.random.default_rng(Smax + Hq + D)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), backend=backend)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, Hq, D)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def _prefill_case(B, Hq, Hkv, Sq, Sk, D, offs, seed=3):
    """The layout of ``test_serve_fastpath``: cache slots hold position r
    below each row's offset (holes above), the chunk's last two entries
    are per-row padding holes."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    offs = np.asarray(offs, np.int32)
    q_pos = offs[:, None] + np.arange(Sq, dtype=np.int32)[None, :]
    r = np.arange(Sk - Sq, dtype=np.int32)[None, :]
    kpos_cache = np.where(r < offs[:, None], r, -1)
    kpos_new = np.where(np.arange(Sq)[None, :] < Sq - 2, q_pos, -1)
    k_pos = np.concatenate([kpos_cache, kpos_new], axis=1).astype(np.int32)
    return q, k, v, q_pos.astype(np.int32), k_pos


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "kind,kw",
    [("causal", {}), ("sliding", {"window": 16}), ("chunked", {"chunk": 16})],
)
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D,offs",
    [
        (2, 4, 2, 8, 72, 32, [5, 23]),           # the fastpath test's layout
        (2, 8, 1, 4, 68, 16, [0, 60]),           # G = 8 at the smoke width
    ],
)
def test_prefill_matches_reference(B, Hq, Hkv, Sq, Sk, D, offs, kind, kw,
                                   dtype, backend):
    q, k, v, q_pos, k_pos = _prefill_case(B, Hq, Hkv, Sq, Sk, D, offs)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jops.prefill_attention(
        jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
        kind=kind, backend=backend, **kw,
    )
    got = tops.prefill_attention(
        tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        kind=kind, **kw,
    )
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("kind,kw", [("causal", {}), ("sliding", {"window": 16})])
def test_prefill_two_sources_equal_concatenation(kind, kw):
    """The model's form — cache and chunk as two key sources — is the
    reference's one-source function on their concatenation."""
    B, Hq, Hkv, Sq, Sk, D = 2, 4, 2, 8, 72, 32
    q, k, v, q_pos, k_pos = _prefill_case(B, Hq, Hkv, Sq, Sk, D, [5, 23])
    t = {n: torch.from_numpy(a) for n, a in
         dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos).items()}
    Sc = Sk - Sq
    one = tops.prefill_attention(t["q"], t["k"], t["v"], t["q_pos"], t["k_pos"],
                                 kind=kind, **kw)
    two = tops.prefill_attention(
        t["q"], t["k"][:, :, :Sc], t["v"][:, :, :Sc], t["q_pos"], t["k_pos"],
        k_new=t["k"][:, :, Sc:], v_new=t["v"][:, :, Sc:], kind=kind, **kw,
    )
    torch.testing.assert_close(one, two, rtol=0, atol=0)


def test_wrappers_refuse_cpu_tensors_without_building():
    """A CPU tensor never reaches a kernel wrapper through ops; called
    directly, the wrappers raise before anything is built."""
    from repro_torch.kernels import _build

    q = torch.zeros(1, 2, 16)
    cache = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, cache, cache, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(q[:, :, None], cache, cache,
                      torch.zeros(1, 1, dtype=torch.int32),
                      torch.zeros(1, 8, dtype=torch.int32))
    assert not _build._LIBS


def test_ops_refuse_other_devices():
    q = torch.zeros(1, 2, 16, device="meta")
    cache = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        tops.decode_attention(q, cache, cache, torch.ones(1, dtype=torch.int32))
