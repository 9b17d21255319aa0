"""Int8 gradient compression (``repro_torch.optim.compression``) and the
mesh builders (``repro_torch.launch.mesh``) against the JAX reference.

* ``quantize`` / ``dequantize``: q (int8) and scale (f32) bit-equal to the
  reference's for f32 and bf16 inputs, an all-zero vector and a size off
  any multiple; the reference's hypothesis properties
  (``tests/test_properties.py``) and its error-feedback bias test
  (``tests/test_distributed.py``) on the port.
* ``quantized_all_reduce`` over 8 gloo ranks with different inputs (8 x
  64 and 8 x 61) against the reference's ``shard_map`` over 8 CPU devices:
  within one step of the second quantization (``scale2``, rtol 0); both
  within 3e-2 of the true mean.
* ``compressed_grad_sync`` over a (2,) ``pod`` mesh with equal per-rank
  grads and error feedback: the reference's ``(synced, new_ef)`` within
  ``scale2``; the inputs themselves with no pod axis or one rank on it.

The port's ranks are gloo processes on the CPU and the reference runs in
a subprocess with forced host devices (``tests/torch_ranks.py``).  Inputs
are seeded numpy.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import compression as jcomp
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import compression as tcomp
from torch_ranks import run_ranks, run_reference

jax.config.update("jax_platform_name", "cpu")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _quantize_both(x: np.ndarray, dtype: str):
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x)
    tx = tx.to(torch.bfloat16) if dtype == "bfloat16" else tx
    return jcomp.quantize(jx), tcomp.quantize(tx)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

_CASES = {
    "normal": lambda rng: rng.normal(size=(8, 64)).astype(np.float32),
    "wide": lambda rng: (rng.normal(size=(3, 61)) * 1e3).astype(np.float32),
    "zeros": lambda rng: np.zeros(64, np.float32),
    "odd_size": lambda rng: rng.normal(size=61).astype(np.float32) * 1e-3,
    "halves": lambda rng: (np.arange(-300, 301, dtype=np.float32) / 2.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_quantize_bit_equal_to_reference(case, dtype):
    x = _CASES[case](np.random.default_rng(0))
    (jq, js), (tq, ts) = _quantize_both(x, dtype)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == ()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()) == _bits(js)
    np.testing.assert_array_equal(
        _bits(tcomp.dequantize(tq, ts).numpy()), _bits(jcomp.dequantize(jq, js)))


@settings(max_examples=40, deadline=None)
@given(st.floats(1e-4, 1e4), st.integers(0, 2**31 - 1))
def test_quantize_roundtrip_error_bound(scale, seed):
    """``tests/test_properties.py``: max error <= half a step; and the bits
    are the reference's."""
    x = (np.random.default_rng(seed).normal(size=128) * scale).astype(np.float32)
    (jq, js), (q, s) = _quantize_both(x, "float32")
    err = (tcomp.dequantize(q, s) - torch.from_numpy(x)).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-9
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s.numpy()) == _bits(js)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_quantize_preserves_sign_and_zero(seed):
    x = torch.tensor([0.0, 1.0, -1.0, 0.5])
    deq = tcomp.dequantize(*tcomp.quantize(x))
    assert float(deq[0]) == 0.0
    assert float(deq[1]) > 0 and float(deq[2]) < 0


def test_error_feedback_reduces_bias():
    """``tests/test_distributed.py``'s test on the port: the running sum of
    error-fed compressed values tracks the true sum better than
    independent quantization; the errors are the reference's."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(100, 64)).astype(np.float32) * 0.01
    g[:, 0] += 5.0                       # a large coordinate dominates the scale
    errs = {}
    for name, quantize, dequantize, wrap in (
        ("port", tcomp.quantize, tcomp.dequantize, torch.from_numpy),
        ("reference", jcomp.quantize, jcomp.dequantize, jnp.asarray),
    ):
        ef = np.zeros(64, np.float32)
        sum_ef, sum_naive, sum_true = 0.0, 0.0, 0.0
        for t in range(100):
            deq = np.asarray(dequantize(*quantize(wrap(g[t] + ef))))
            ef = g[t] + ef - deq
            sum_ef += deq
            sum_naive += np.asarray(dequantize(*quantize(wrap(g[t]))))
            sum_true += g[t]
        errs[name] = (np.abs(sum_ef - sum_true).max(), np.abs(sum_naive - sum_true).max())
    err_ef, err_naive = errs["port"]
    assert err_ef <= err_naive + 1e-6, (err_ef, err_naive)
    assert err_ef < 0.1
    np.testing.assert_allclose(errs["port"], errs["reference"], rtol=1e-6)


def test_init_error_feedback_is_f32_zeros_per_leaf():
    grads = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(5)]}
    ef = tcomp.init_error_feedback(grads)
    assert ef["a"].shape == (3, 4) and ef["a"].dtype == torch.float32
    assert ef["b"][0].shape == (5,) and float(ef["b"][0].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the mesh builders
# ---------------------------------------------------------------------------

def test_mesh_needs_an_initialized_group():
    """No process group: every builder raises, none falls back to one device."""
    assert not torch.distributed.is_initialized()
    for build in (lambda: tmesh.make_mesh_for((1,), ("pod",)),
                  lambda: tmesh.make_production_mesh(),
                  lambda: tmesh.make_production_mesh(multi_pod=True),
                  lambda: tmesh.make_donor_mesh((1,), ("data",), 2)):
        with pytest.raises(RuntimeError, match="process group"):
            build()
    with pytest.raises(ValueError, match="donor axis needs >= 2"):
        tmesh.make_donor_mesh(donor_size=1)
    with pytest.raises(ValueError, match="pair up"):
        tmesh.make_mesh_for((2, 2), ("pod",))


def test_mesh_axes_of_none_and_of_a_mesh():
    assert tmesh.mesh_axes_dict(None) == {} and tmesh.axis_size(None, "pod") == 1
    fake = types.SimpleNamespace(mesh_dim_names=("pod", "data"), shape=(2, 4))
    assert tmesh.mesh_axes_dict(fake) == {"pod": 2, "data": 4}
    assert tmesh.axis_size(fake, "model") == 1
    assert (tmesh.DONOR_AXIS, tmesh.REMOTE_DONOR_AXIS) == ("donor", "donor_pod")


def test_identity_without_a_mesh():
    grads = {"w": torch.randn(3, 4)}
    ef = tcomp.init_error_feedback(grads)
    out, new_ef = tcomp.compressed_grad_sync(grads, ef, None)
    assert out is grads and new_ef is ef
    x = torch.randn(7)
    assert tcomp.quantized_all_reduce(x, None) is x


# ---------------------------------------------------------------------------
# collectives over gloo ranks against the reference's shard_map
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(1)
    return {
        "x64": rng.normal(size=(8, 64)).astype(np.float32),
        "x61": rng.normal(size=(8, 61)).astype(np.float32),
        "g_w": rng.normal(size=(8, 5)).astype(np.float32) * 0.1,
        "g_b": rng.normal(size=(7,)).astype(np.float32),
        "e_w": rng.normal(size=(8, 5)).astype(np.float32) * 1e-3,
        "e_b": rng.normal(size=(7,)).astype(np.float32) * 1e-3,
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on 8 forced CPU devices."""
    tmp = tmp_path_factory.mktemp("compression_ref")
    np.savez(tmp / "inputs.npz", **_inputs())
    return run_reference(f"""
        import jax, jax.numpy as jnp
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import make_mesh_compat
        from repro.optim.compression import compressed_grad_sync, quantized_all_reduce
        inp = dict(np.load({str(tmp / "inputs.npz")!r}))
        mesh = make_mesh_compat((8,), ("pod",))
        f = shard_map(lambda v: quantized_all_reduce(v[0], "pod")[None],
                      mesh=mesh, in_specs=P("pod"), out_specs=P("pod"), check_rep=False)
        for k in ("x64", "x61"):
            out["qar_" + k] = np.asarray(f(jnp.asarray(inp[k])))
        pod2 = make_mesh_compat((2,), ("pod",))
        grads = {{"w": jnp.asarray(inp["g_w"]), "b": jnp.asarray(inp["g_b"], jnp.bfloat16)}}
        ef = {{"w": jnp.asarray(inp["e_w"]), "b": jnp.asarray(inp["e_b"])}}
        synced, new_ef = compressed_grad_sync(grads, ef, pod2, "pod")
        for k in ("w", "b"):
            out["sync_" + k] = np.asarray(synced[k].astype(jnp.float32))
            out["ef_" + k] = np.asarray(new_ef[k])
        out["sync_b_dtype"] = np.asarray(str(synced["b"].dtype))
    """, tmp)


def _scale2_tol(want: np.ndarray, n: int) -> np.ndarray:
    """One step of the second quantization, per element: a segment's
    dequantized mean reaches +-127 steps exactly, so its step is its
    largest |value| / 127 (segments of the flat, padded tensor)."""
    flat = want.reshape(-1)
    seg = -(-flat.size // n)
    pad = np.pad(np.abs(flat), (0, seg * n - flat.size)).reshape(n, seg)
    step = pad.max(1, keepdims=True) / 127.0
    return (np.broadcast_to(step, pad.shape).reshape(-1)[:flat.size] * (1 + 1e-5)
            + 1e-12).reshape(want.shape)


@pytest.mark.parametrize("key", ["x64", "x61"])
def test_quantized_all_reduce_over_8_ranks_matches_reference(key, reference, tmp_path):
    x = _inputs()[key]
    outs = run_ranks("""
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.optim.compression import quantized_all_reduce
        mesh = make_mesh_for((8,), ("pod",))
        x = torch.from_numpy(inputs[rank])
        out["y"] = quantized_all_reduce(x, mesh.get_group("pod")).numpy()
    """, 8, tmp_path, inputs=x)
    ys = np.stack([o["y"] for o in outs])
    want = reference["qar_" + key]
    for r in range(1, 8):                      # every rank holds the same result
        np.testing.assert_array_equal(ys[r], ys[0])
    tol = _scale2_tol(want[0], 8)
    assert (np.abs(ys[0] - want[0]) <= tol).all(), np.abs(ys[0] - want[0]).max()
    mean = x.mean(0)
    np.testing.assert_allclose(ys[0], mean, atol=3e-2, rtol=0)
    np.testing.assert_allclose(want[0], mean, atol=3e-2, rtol=0)


def test_compressed_grad_sync_over_a_pod_mesh_matches_reference(reference, tmp_path):
    inp = _inputs()
    outs = run_ranks("""
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.optim.compression import compressed_grad_sync
        grads = {"w": torch.from_numpy(inputs["g_w"]),
                 "b": torch.from_numpy(inputs["g_b"]).to(torch.bfloat16)}
        ef = {"w": torch.from_numpy(inputs["e_w"]), "b": torch.from_numpy(inputs["e_b"])}
        synced, new_ef = compressed_grad_sync(grads, ef, make_mesh_for((2,), ("pod",)))
        out["sync"] = {k: v.float().numpy() for k, v in synced.items()}
        out["ef"] = {k: v.numpy() for k, v in new_ef.items()}
        out["dtypes"] = {k: str(v.dtype) for k, v in synced.items()}
        # no pod axis, and a pod axis of one rank: the inputs come back
        for shape, axes in (((2,), ("data",)), ((1, 2), ("pod", "data"))):
            s2, e2 = compressed_grad_sync(grads, ef, make_mesh_for(shape, axes))
            out.setdefault("identity", []).append(s2 is grads and e2 is ef)
    """, 2, tmp_path, inputs=inp)
    assert outs[0]["dtypes"] == {"w": "torch.float32", "b": "torch.bfloat16"}
    assert str(reference["sync_b_dtype"]) == "bfloat16"
    for o in outs:
        assert o["identity"] == [True, True]
        for k in ("w", "b"):
            np.testing.assert_array_equal(o["sync"][k], outs[0]["sync"][k])
    for k in ("w", "b"):
        want, got = reference["sync_" + k], outs[0]["sync"][k]
        tol = _scale2_tol(want, 2)
        if k == "b":                           # synced back to bf16: one bf16 ulp more
            tol = tol + np.abs(want) * 2.0 ** -8
        assert (np.abs(got - want) <= tol).all(), (k, np.abs(got - want).max())
        np.testing.assert_array_less(np.abs(outs[0]["ef"][k] - reference["ef_" + k]),
                                     _scale2_tol(want, 2) + 1e-7)
