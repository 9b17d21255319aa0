"""Training with the params in host memory, on the CPU.

Under ``params=host`` (RESIDENT) the step reads the params in place and
the update writes the new params back into the same host arena; under
``weights_stream`` (``params=host:stream``) the forward stages each
params window through a ``HostStream`` of two slots, the backward fetches
the windows again last first, and the update copies each window's new
params back into the host tree; ``params=host:stream,master=host:stream,
opt_state=host:stream`` streams all three roles through one walk.  Every
layer runs as ``remat="full"``, so 3 AdamW steps in float32 give losses,
grad norms, params and optimizer state **bit for bit** equal to the
port's ``hbm_resident`` run under ``remat="full"`` (``"none"`` runs as
full), for the dense models, MoE (``aux``), Mamba-2 and Zamba-2 (its
shared block in each window that applies it, the summed gradient of the
embedding output that every ``S`` layer reads: a test-only config of two
pattern periods), and against the reference's ``hbm_resident`` run within
``tests/test_torch_train.py``'s tolerances (its own host-placed runs abort
on this JAX, ROADMAP C3).  The host params keep their storage; a
checkpoint restored under ``weights_stream`` continues exactly; the
launcher takes the policy; an encoder-decoder refuses (ROADMAP A7c).
About 35 s on one thread.
"""

import dataclasses
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.core import warnings_registry
from repro_torch.core.placement import HostStream
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

from test_torch_train import _bundles, _jax_train, _t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {
    "olmo-1b": None, "yi-6b": None, "llama4-maverick-400b-a17b": None,
    "mamba2-780m": None, "zamba2-1.2b": None,
    # two MMMMMS periods: two windows apply the shared block
    "zamba2-1.2b x2": dict(n_layers=12),
}
ALL_STREAM = "params=host:stream,master=host:stream,opt_state=host:stream"
PLACEMENTS = ("params=host", "weights_stream", ALL_STREAM)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread runs them as fast and leaves the
    cores to the suite's other processes.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle(model):
    cfg = dataclasses.replace(smoke_config(model.split()[0]), dtype="float32")
    return ModelBundle(dataclasses.replace(cfg, **(MODELS[model] or {})))


def _batches(cfg, n, B=4, S=16):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    return [{k: _t(v) for k, v in next(data).items()} for _ in range(n)]


def _train(tb, policy, steps=3, remat="full", microbatches=1, start=None):
    """(per step (loss, grad norm, params), the final state, the step,
    the params' (data_ptr, arena) after init)."""
    tcfg = TrainConfig(remat=remat, n_microbatches=microbatches, policy=policy,
                       optimizer=AdamWConfig(lr=1e-3, warmup_steps=2))
    if start is None:
        params, opt, ef = init_train_state(tb, torch.Generator().manual_seed(0), tcfg)
    else:
        params, opt, ef = start
    where = [(t.data_ptr(), getattr(t, "_host_arena", None)) for t in tree_leaves(params)]
    step = make_train_step(tb, tcfg)
    out = []
    for batch in _batches(tb.cfg, steps):
        params, opt, ef, m = step(params, opt, ef, batch)
        out.append((m["loss"].clone(), m["grad_norm"].clone(), tree_map(torch.clone, params)))
    return out, (params, opt, ef), step, where


def _equal(a, b):
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def _same_run(got, want):
    for (gl, gg, gp), (wl, wg, wp) in zip(got[0], want[0], strict=True):
        assert torch.equal(gl, wl) and torch.equal(gg, wg)
        assert _equal(gp, wp)
    for k in ("master", "mu", "nu"):
        assert _equal(got[1][1][k], want[1][1][k])
    assert int(got[1][1]["step"]) == int(want[1][1]["step"])


@pytest.fixture(scope="module")
def resident_runs():
    return {model: _train(_bundle(model), None) for model in MODELS}


@pytest.mark.parametrize("policy", PLACEMENTS)
@pytest.mark.parametrize("model", list(MODELS))
def test_steps_equal_hbm_resident_bit_for_bit(model, policy, resident_runs):
    tb = _bundle(model)
    got = _train(tb, policy)
    _same_run(got, resident_runs[model])
    params, where = got[1][0], got[3]
    # the host tree is the state: the same storage, in its arena, after the steps
    assert all(w[1] is not None for w in where)
    assert [(t.data_ptr(), t._host_arena) for t in tree_leaves(params)] == where
    # none of its leaves became a graph leaf
    assert not any(t.requires_grad or t.grad is not None for t in tree_leaves(params))


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_streamed_params_run_every_layer_as_full(remat, resident_runs, caplog):
    warnings_registry.reset_warnings("train_remat")
    tb = _bundle("llama4-maverick-400b-a17b")
    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        got = _train(tb, "weights_stream", remat=remat)
        _train(tb, "weights_stream", remat=remat, steps=1)
    _same_run(got, resident_runs["llama4-maverick-400b-a17b"])
    said = [r for r in caplog.records if "runs as 'full'" in r.getMessage()]
    assert len(said) == 1, [r.getMessage() for r in caplog.records]


def test_microbatches_stream_the_windows_once_each():
    tb = _bundle("yi-6b")
    want = _train(tb, None, steps=2, microbatches=2)
    got = _train(tb, "weights_stream", steps=2, microbatches=2)
    _same_run(got, want)
    source = got[2].placed["streams"]["source"]
    n = source.n_windows
    one = list(range(n)) + list(range(n - 2, -1, -1))
    assert list(source.fetches) == one * 4         # 2 microbatches x 2 steps


def test_weights_stream_matches_the_reference():
    """olmo-1b-smoke from the reference's own initial state, as
    ``tests/test_torch_placed_train.py`` holds ``opt_host``."""
    lr, warmup, steps = 1e-3, 2, 3
    (jparams, jopt, _), ref_steps = _jax_train("olmo-1b", steps, lr, warmup)
    _, tb = _bundles("olmo-1b")
    params, opt = convert.params_from_jax((jparams, jopt), "cpu")
    ef = tree_map(lambda p: torch.zeros(()), params)
    placed = _train(tb, "weights_stream", start=(params, opt, ef))[0]
    lr_sum = 0.0
    for i, ((jloss, jgnorm, jp), (pl, pg, pp)) in enumerate(zip(ref_steps, placed)):
        lr_sum += lr * min((i + 1) / warmup, 1.0)
        np.testing.assert_allclose(float(pl), jloss, rtol=1e-5 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(pg), jgnorm, rtol=1e-4)
        diffs = []
        tree_map(lambda g, w: diffs.append(np.abs(g.numpy() - w).ravel()), pp, jp)
        diffs = np.concatenate(diffs)
        assert diffs.max() <= 2 * lr_sum * 1.1, (i, diffs.max())
        assert np.quantile(diffs, 0.99) <= 1e-5, (i, np.quantile(diffs, 0.99))


def test_backward_fetches_the_windows_last_first():
    tb = _bundle("olmo-1b")
    _, _, step, _ = _train(tb, "weights_stream", steps=1)
    source, update = step.placed["streams"]["source"], step.placed["streams"]["params"]
    n = source.n_windows
    assert n == tb.cfg.n_layers + 2
    # forward 0..n-1 (the tail last), then the backward n-2..0
    assert list(source.fetches) == list(range(n)) + list(range(n - 2, -1, -1))
    # the update writes back through the same slots and fetches nothing
    assert list(update.fetches) == [] and update.buffers() == source.buffers()


def test_host_stream_in_reverse_prefetches_the_window_before():
    host = torch.arange(5 * 6, dtype=torch.float32).reshape(5, 6)
    st = HostStream.stacked({"w": host}, 5, "cpu")
    st.begin(reverse=True)
    for i in reversed(range(5)):
        assert torch.equal(st.window(i)["w"], host[i])
        assert sorted(st._held) == sorted(j for j in (i, i - 1) if j >= 0)
    assert list(st.fetches) == [4, 3, 2, 1, 0]
    st.begin()
    st.window(0)
    assert list(st.fetches)[-2:] == [0, 1]
    # a staged window is written, then copied back: nothing read from host
    st.begin()
    st.stage(3)["w"].fill_(-1)
    st.write_back(3)
    assert (host[3] == -1).all() and list(st.fetches)[-1] == 1


def test_restart_from_a_checkpoint_under_weights_stream_is_exact(tmp_path):
    tb = _bundle("olmo-1b")
    tcfg = TrainConfig(remat="full", policy="weights_stream",
                       optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, weight_decay=0.0))
    state = init_train_state(tb, torch.Generator().manual_seed(0), tcfg)
    step = make_train_step(tb, tcfg)

    def run(state, n, start):
        data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=32, global_batch=8))
        data.restore({"step": start, "seed": 0})
        params, opt, ef = state
        losses = []
        for _, batch in zip(range(n), data):
            params, opt, ef, m = step(params, opt, ef, {k: _t(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
        return (params, opt, ef), losses

    state, _ = run(state, 3, 0)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"params": state[0], "opt": state[1], "ef": state[2]}, blocking=True)
    state, cont = run(state, 3, 3)
    after = tree_map(torch.clone, state[0])
    restored, _ = ck.restore({"params": state[0], "opt": state[1], "ef": state[2]})
    # the restored params are plain tensors: the step places them in host memory again
    assert all(getattr(t, "_host_arena", None) is None for t in tree_leaves(restored["params"]))
    state2, cont2 = run((restored["params"], restored["opt"], restored["ef"]), 3, 3)
    assert cont == cont2
    assert _equal(state2[0], after)
    assert all(t._host_arena is not None for t in tree_leaves(state2[0]))


def test_an_encoder_decoder_with_params_in_host_memory_raises():
    tb = ModelBundle(dataclasses.replace(smoke_config("seamless-m4t-medium"),
                                         dtype="float32"))
    for policy in ("params=host", "weights_stream"):
        with pytest.raises(NotImplementedError, match="ROADMAP A7c"):
            init_train_state(tb, torch.Generator().manual_seed(0), TrainConfig(policy=policy))
    # its optimizer state may live there
    init_train_state(tb, torch.Generator().manual_seed(0), TrainConfig(policy="opt_host"))


@pytest.mark.parametrize("policy", ["weights_stream", "params=host"])
def test_launch_train_takes_a_params_placement(policy, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt-every", "100", "--ckpt-dir", str(tmp_path),
         "--policy", policy],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert f"training under placement policy {policy}" in res.stderr, res.stderr
    assert "params in host memory (host" in res.stderr, res.stderr
    assert "done: 2 steps" in res.stderr, res.stderr
