"""Training data parallel over a ``pod`` axis, the launcher's ``--mesh``
and ``--compress-pod-grads``, and the end-to-end example.

* two gloo ranks on a (2,) ``pod`` mesh train granite-8b-smoke for 4
  steps: the losses equal the port's one-device losses and the reference's
  one-device losses at rtol/atol 2e-3 (``tests/test_distributed.py``'s
  limit), from the reference's initial weights; both ranks hold the same
  losses and weights;
* olmo-1b-smoke with ``compress_pod_grads=True`` over two ranks, 30
  steps: the loss falls by more than 0.2 (``tests/test_distributed.py``);
* ``compress_pod_grads`` on one device is the reference's no-op;
* ``check_ported`` takes a ``data``/``model`` axis of several ranks since
  ROADMAP A10b (``tests/test_torch_mesh_train.py``) and still refuses a
  donor axis (A10c), a ``model`` axis over a family without tensor-parallel
  layers (A10b, rest) and an encoder-decoder's ZeRO-3 over ``data`` (A7c);
* ``launch.train --mesh 2x1x1 --compress-pod-grads --device cpu`` under
  ``torchrun --standalone`` with two ranks; ``--donor 2`` refused naming
  A10c, a mesh of several ranks without torchrun refused;
* ``examples.train_e2e --tiny --device cpu`` learns and resumes.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.mesh import make_mesh_for as jax_mesh_for
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.examples import train_e2e
from repro_torch.launch.train import parse_args, train
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from torch_ranks import ROOT, run_ranks

jax.config.update("jax_platform_name", "cpu")

#: tests/test_distributed.py's limit between a sharded and a one-device run
POD_TOL = dict(rtol=2e-3, atol=2e-3)
STEPS, LR = 4, 1e-3


@pytest.fixture(scope="module")
def granite():
    """The reference's one-device run of granite-8b-smoke (4 AdamW steps,
    8 x 32 tokens) and its initial weights, carried across."""
    jb = JaxBundle(jax_smoke_config("granite-8b"))
    mesh = jax_mesh_for((1,), ("data",))
    tcfg = JaxTrainConfig(remat="none", optimizer=JaxAdamWConfig(lr=LR, warmup_steps=1))
    params, opt, ef = jax_init_train_state(jb, mesh, jax.random.PRNGKey(0), tcfg)
    start = convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    step = jax.jit(jax_make_train_step(jb, mesh, tcfg))
    data = JaxSyntheticLM(JaxDataConfig(vocab=jb.cfg.vocab, seq_len=32, global_batch=8))
    losses = []
    for _ in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, opt, ef, m = step(params, opt, ef, batch)
        losses.append(float(m["loss"]))
    return start, losses


def _one_device_losses(start):
    tb = ModelBundle(smoke_config("granite-8b"))
    params = {k: v for k, v in start.items()}
    opt = init_opt_state(params)
    step = make_train_step(tb, TrainConfig(
        remat="none", optimizer=AdamWConfig(lr=LR, warmup_steps=1)))
    data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=32, global_batch=8))
    losses = []
    for _ in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params, opt, _, m = step(params, opt, None, batch)
        losses.append(float(m["loss"]))
    return losses


def test_two_pod_ranks_train_as_one_device(granite, tmp_path):
    start, ref_losses = granite
    outs = run_ranks(f"""
        from repro_torch.configs import smoke_config
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models.model_zoo import ModelBundle
        from repro_torch.optim import AdamWConfig, init_opt_state
        from repro_torch.train import TrainConfig, make_train_step
        mesh = make_mesh_for((2,), ("pod",))
        tb = ModelBundle(smoke_config("granite-8b"))
        params = inputs
        opt = init_opt_state(params)
        step = make_train_step(tb, TrainConfig(
            remat="none", optimizer=AdamWConfig(lr={LR}, warmup_steps=1)), mesh)
        data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=32, global_batch=8),
                           process_index=rank, process_count=world)
        out["losses"] = []
        for _ in range({STEPS}):
            batch = {{k: torch.from_numpy(v) for k, v in next(data).items()}}
            assert batch["tokens"].shape == (4, 32)
            params, opt, _, m = step(params, opt, None, batch)
            out["losses"].append(float(m["loss"]))
        out["params"] = params
    """, 2, tmp_path, inputs=start)
    assert outs[0]["losses"] == outs[1]["losses"]
    for a, b in zip(tree_leaves(outs[0]["params"]), tree_leaves(outs[1]["params"])):
        assert torch.equal(a, b)
    np.testing.assert_allclose(outs[0]["losses"], _one_device_losses(start), **POD_TOL)
    np.testing.assert_allclose(outs[0]["losses"], ref_losses, **POD_TOL)


def test_compressed_pod_grads_still_learn(tmp_path):
    outs = run_ranks("""
        from repro_torch.configs import smoke_config
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models.model_zoo import ModelBundle
        from repro_torch.models.sharding import tree_leaves
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import TrainConfig, init_train_state, make_train_step
        mesh = make_mesh_for((2,), ("pod",))
        b = ModelBundle(smoke_config("olmo-1b"))
        tcfg = TrainConfig(remat="none", compress_pod_grads=True,
                           optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, weight_decay=0.0))
        params, opt, ef = init_train_state(b, torch.Generator().manual_seed(0), tcfg, mesh)
        assert all(e.shape == p.shape for e, p in zip(tree_leaves(ef), tree_leaves(params)))
        step = make_train_step(b, tcfg, mesh)
        data = SyntheticLM(DataConfig(vocab=b.cfg.vocab, seq_len=32, global_batch=8,
                                      structure=1.0), process_index=rank, process_count=world)
        out["losses"] = []
        for _ in range(30):
            batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
            params, opt, ef, m = step(params, opt, ef, batch)
            out["losses"].append(float(m["loss"]))
        out["params"], out["ef_norm"] = params, sum(float(e.norm()) for e in tree_leaves(ef))
    """, 2, tmp_path, timeout=240)
    losses = outs[0]["losses"]
    assert outs[1]["losses"] == losses
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])
    assert all(o["ef_norm"] > 0 for o in outs)     # the residuals are carried
    for a, b in zip(tree_leaves(outs[0]["params"]), tree_leaves(outs[1]["params"])):
        assert torch.equal(a, b)


def test_compression_without_a_pod_axis_is_a_no_op():
    """One device: ``compress_pod_grads`` leaves the gradients as they are,
    so the losses are those without it, bit for bit, and ``ef`` stays
    zero."""
    b = ModelBundle(smoke_config("olmo-1b"))
    runs = {}
    for compress in (False, True):
        tcfg = TrainConfig(remat="none", compress_pod_grads=compress,
                           optimizer=AdamWConfig(lr=3e-3, warmup_steps=2))
        params, opt, ef = init_train_state(b, torch.Generator().manual_seed(0), tcfg)
        step = make_train_step(b, tcfg)
        data = SyntheticLM(DataConfig(vocab=b.cfg.vocab, seq_len=16, global_batch=4))
        losses = []
        for _ in range(3):
            batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
            params, opt, ef, m = step(params, opt, ef, batch)
            losses.append(float(m["loss"]))
        runs[compress] = losses, ef
    assert runs[True][0] == runs[False][0]
    ef = tree_leaves(runs[True][1])
    assert ef[0].ndim > 0 and all(float(e.abs().max()) == 0.0 for e in ef)
    assert all(e.shape == () for e in tree_leaves(runs[False][1]))


@pytest.mark.parametrize("axes", [{"data": 2}, {"model": 2}, {"pod": 2, "data": 2}])
def test_check_ported_refuses_data_and_model_axes(axes):
    """What a data/model mesh still refuses: a donor axis beside it, a
    model axis over MoE layers, ZeRO-3 of an encoder-decoder over data."""
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(axes.values()))
    TrainConfig().check_ported(mesh, ModelBundle(smoke_config("granite-8b")))
    donor = types.SimpleNamespace(mesh_dim_names=(*axes, "donor"), shape=(*axes.values(), 2))
    with pytest.raises(NotImplementedError, match="A10c"):
        TrainConfig().check_ported(donor)
    llama4 = ModelBundle(smoke_config("llama4-maverick-400b-a17b"))
    seamless = ModelBundle(smoke_config("seamless-m4t-medium"))
    if "model" in axes:
        for bundle in (llama4, seamless):
            with pytest.raises(NotImplementedError, match="A10b, rest"):
                TrainConfig().check_ported(mesh, bundle)
    else:
        TrainConfig().check_ported(mesh, llama4)
        with pytest.raises(NotImplementedError, match="A7c"):
            TrainConfig().check_ported(mesh, seamless)
        TrainConfig(zero_stage=1).check_ported(mesh, seamless)
    TrainConfig(compress_pod_grads=True).check_ported(
        types.SimpleNamespace(mesh_dim_names=("pod", "data"), shape=(4, 1)))


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def test_launcher_trains_two_pod_ranks_under_torchrun(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--smoke", "--device", "cpu", "--mesh", "2x1x1", "--compress-pod-grads",
         "--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1",
         "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    for r in (0, 1):
        assert f"rank {r} of 2 on the pod axis" in res.stderr, res.stderr[-4000:]
        assert os.listdir(tmp_path / f"rank_{r}") == ["step_00000002"]
    assert res.stderr.count("done: 3 steps") == 2, res.stderr[-4000:]


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "1x2x1"], "torchrun"),
    (["--mesh", "4x2"], "torchrun"),
    (["--donor", "2"], "A10c"),
    (["--remote-donor", "2"], "A10c"),
    (["--mesh", "2x1x1"], "torchrun"),
])
def test_launcher_refuses_what_is_not_ported(argv, match, monkeypatch, tmp_path):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = parse_args(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path), *argv])
    with pytest.raises(SystemExit, match=match):
        train(args)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("steps", [30, 28])
def test_train_e2e_tiny_learns_and_resumes(steps, tmp_path):
    """30 steps: checkpoints every 7, the last at 28, two steps replayed
    with the same losses; 28 steps: the last checkpoint is the final step,
    and its state (scalars included) is the final state bit for bit."""
    out = train_e2e.train(train_e2e.parse_args(
        ["--tiny", "--device", "cpu", "--steps", str(steps), "--ckpt-dir", str(tmp_path)]))
    losses = out["losses"]
    assert len(losses) == out["steps"] == steps and losses[-1] < losses[0]
    assert out["cfg"].name == "repro-tiny" and out["stragglers"]["steps"] == steps
    assert out["resumed"] == 28 and out["replayed"] == losses[28:]
    assert sorted(os.listdir(out["ckpt_dir"])) == [f"step_{s:08d}" for s in (14, 21, 28)]


def test_repro_100m_is_the_reference_config():
    """The example's configs are the reference's (100.07 M params)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_e2e as ref_e2e
    finally:
        sys.path.remove(str(ROOT / "examples"))
    for ours, theirs in ((train_e2e.config_100m(), ref_e2e.config_100m()),
                         (train_e2e.config_tiny(), ref_e2e.config_tiny())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert train_e2e.config_100m().num_params() == 100_073_472
