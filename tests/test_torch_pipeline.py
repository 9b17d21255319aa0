"""GPipe pipelining over the ``pod`` axis
(``repro_torch.train.pipeline_parallel``) against the JAX reference.

* ``pipelined_forward`` over 4 gloo ranks (4 stages, 8 microbatches, B 2,
  D 16): every rank's output equals the reference's ``shard_map`` output
  on 4 CPU devices and the sequential stage loop at 1e-5.
* over 2 ranks, the gradients of ``sum(y ** 2)`` summed over the ranks
  equal the reference's ``jax.grad`` at 1e-4, for the stacked weights,
  and the sequential model's for the microbatches.
* one stage without a mesh is the sequential loop; stacked params whose
  leading dim is not the axis's size are refused.

The stage is the reference test's ``tanh(x @ w)``; weights and inputs are
seeded numpy, the port's ranks gloo processes (``tests/torch_ranks.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.train import pipelined_forward
from torch_ranks import run_ranks, run_reference


def _inputs(n_stages, n_micro, B, D, seed=0):
    rng = np.random.default_rng(seed)
    return {"ws": (rng.normal(size=(n_stages, D, D)) * 0.3).astype(np.float32),
            "xs": rng.normal(size=(n_micro, B, D)).astype(np.float32)}


def _sequential(ws, xs):
    x = xs
    for w in ws:
        x = torch.tanh(x @ w)
    return x


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's forward on a (4,) pod mesh and its gradient on a
    (2,) one."""
    tmp = tmp_path_factory.mktemp("pipeline_ref")
    np.savez(tmp / "fwd.npz", **_inputs(4, 8, 2, 16))
    np.savez(tmp / "grad.npz", **_inputs(2, 4, 2, 8, seed=1))
    return run_reference(f"""
        import jax, jax.numpy as jnp
        from repro.launch.mesh import make_mesh_compat
        from repro.train.pipeline_parallel import pipelined_forward
        def stage_fn(w, x):
            return jnp.tanh(x @ w)
        f = dict(np.load({str(tmp / "fwd.npz")!r}))
        out["fwd"] = np.asarray(pipelined_forward(
            make_mesh_compat((4,), ("pod",)), stage_fn, jnp.asarray(f["ws"]),
            jnp.asarray(f["xs"]), axis_name="pod"))
        g = dict(np.load({str(tmp / "grad.npz")!r}))
        mesh = make_mesh_compat((2,), ("pod",))
        xs = jnp.asarray(g["xs"])
        loss = lambda ws: jnp.sum(pipelined_forward(mesh, stage_fn, ws, xs, "pod") ** 2)
        out["grad"] = np.asarray(jax.grad(loss)(jnp.asarray(g["ws"])))
    """, tmp)


def test_forward_over_4_ranks_matches_reference_and_sequential(reference, tmp_path):
    inp = _inputs(4, 8, 2, 16)
    outs = run_ranks("""
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.train import pipelined_forward
        y = pipelined_forward(make_mesh_for((4,), ("pod",)),
                              lambda w, x: torch.tanh(x @ w),
                              torch.from_numpy(inputs["ws"]), torch.from_numpy(inputs["xs"]))
        out["y"] = y.numpy()
    """, 4, tmp_path, inputs=inp)
    want = _sequential(torch.from_numpy(inp["ws"]), torch.from_numpy(inp["xs"])).numpy()
    np.testing.assert_allclose(reference["fwd"], want, atol=1e-5, rtol=1e-5)
    for o in outs:                             # every rank holds the outputs
        np.testing.assert_allclose(o["y"], reference["fwd"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(o["y"], want, atol=1e-5, rtol=1e-5)


def test_gradients_over_2_ranks_match_reference(reference, tmp_path):
    inp = _inputs(2, 4, 2, 8, seed=1)
    outs = run_ranks("""
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.train import pipelined_forward
        ws = torch.from_numpy(inputs["ws"]).requires_grad_()
        xs = torch.from_numpy(inputs["xs"]).requires_grad_()
        y = pipelined_forward(make_mesh_for((2,), ("pod",)),
                              lambda w, x: torch.tanh(x @ w), ws, xs)
        gw, gx = torch.autograd.grad((y ** 2).sum(), (ws, xs))
        out["gw"], out["gx"] = gw.numpy(), gx.numpy()
    """, 2, tmp_path, inputs=inp)
    gw = sum(o["gw"] for o in outs)
    gx = sum(o["gx"] for o in outs)
    # each rank's gradient is its own stage's: the other slice is zero
    for r, o in enumerate(outs):
        assert float(np.abs(o["gw"][1 - r]).max()) == 0.0
    np.testing.assert_allclose(gw, reference["grad"], atol=1e-4)
    ws = torch.from_numpy(inp["ws"]).requires_grad_()
    xs = torch.from_numpy(inp["xs"]).requires_grad_()
    want_w, want_x = torch.autograd.grad((_sequential(ws, xs) ** 2).sum(), (ws, xs))
    np.testing.assert_allclose(gw, want_w.numpy(), atol=1e-4)
    np.testing.assert_allclose(gx, want_x.numpy(), atol=1e-4)


def test_one_stage_without_a_mesh_is_the_sequential_loop():
    inp = _inputs(1, 3, 2, 8, seed=2)
    ws = torch.from_numpy(inp["ws"]).requires_grad_()
    xs = torch.from_numpy(inp["xs"])
    y = pipelined_forward(None, lambda w, x: torch.tanh(x @ w), ws, xs)
    want = _sequential(ws, xs)
    torch.testing.assert_close(y, want, atol=0, rtol=0)
    g, = torch.autograd.grad(y.sum(), ws)
    g_want, = torch.autograd.grad(want.sum(), ws)
    torch.testing.assert_close(g, g_want)


def test_stack_must_match_the_axis():
    inp = _inputs(2, 3, 2, 8)
    with pytest.raises(ValueError, match="stacked params lead with"):
        pipelined_forward(None, lambda w, x: torch.tanh(x @ w),
                          torch.from_numpy(inp["ws"]), torch.from_numpy(inp["xs"]))
