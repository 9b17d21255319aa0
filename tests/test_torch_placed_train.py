"""Training under ``opt_host`` (the optimizer state streamed from host
memory), on the CPU.

Under ``opt_host`` the f32 master and both Adam moments live in host
memory (plain memory on the CPU, pinned on a card) and each step streams
them through the update window by window, writing each updated window
back; params and grads stay on the device.  The update is elementwise, so
streaming changes no value: 3 AdamW steps of olmo-1b-smoke (and
yi-6b-smoke) in float32 give losses, grad norms, params and optimizer
state **bit for bit** equal to the port's ``hbm_resident`` run, and match
the reference's ``hbm_resident`` run within ``tests/test_torch_train.py``'s
tolerances (the reference's own ``opt_host`` run aborts on this JAX,
ROADMAP C3).  A checkpoint restored under ``opt_host`` continues exactly;
the launcher takes ``--policy``; grads and activations in host memory
raise (RESIDENT ``opt=host`` and ``master=host``:
``tests/test_torch_resident_host.py``; the params in host memory:
``tests/test_torch_params_host_train.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.placement import DonorAxisError
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.checkpoint import Checkpointer
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

from test_torch_train import _bundles, _jax_train, _t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tb, start, policy, steps, lr=1e-3, warmup=2):
    params, opt = start
    params = tree_map(torch.clone, params)
    opt = tree_map(torch.clone, opt)
    step = make_train_step(tb, TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=lr, warmup_steps=warmup), policy=policy))
    data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=16, global_batch=4))
    out = []
    for _ in range(steps):
        batch = {k: _t(v) for k, v in next(data).items()}
        params, opt, _, m = step(params, opt, None, batch)
        out.append((m["loss"].clone(), m["grad_norm"].clone(),
                    tree_map(torch.clone, params)))
    return out, opt


def _equal(a, b):
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-6b"])
def test_opt_host_steps_equal_hbm_resident_and_the_reference(arch):
    lr, warmup, steps = 1e-3, 2, 3
    (jparams, jopt, _), ref_steps = _jax_train(arch, steps, lr, warmup)
    _, tb = _bundles(arch)
    start = convert.params_from_jax((jparams, jopt), "cpu")
    resident, r_opt = _run(tb, start, None, steps, lr, warmup)
    placed, p_opt = _run(tb, start, "opt_host", steps, lr, warmup)
    for (rl, rg, rp), (pl, pg, pp) in zip(resident, placed):
        assert torch.equal(rl, pl) and torch.equal(rg, pg)
        assert _equal(rp, pp)
    for k in ("master", "mu", "nu"):
        assert _equal(r_opt[k], p_opt[k])
        # the placed state lives in a host arena of its own
        assert all(getattr(t, "_host_arena", None) is not None
                   for t in tree_leaves(p_opt[k]))
    assert int(p_opt["step"]) == steps
    # against the reference, as tests/test_torch_train.py holds hbm_resident
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


def test_init_places_the_optimizer_state_in_host_memory():
    _, tb = _bundles("olmo-1b")
    tcfg = TrainConfig(policy="opt_host")
    params, opt, _ = init_train_state(tb, torch.Generator().manual_seed(0), tcfg)
    _, ropt, _ = init_train_state(tb, torch.Generator().manual_seed(0), TrainConfig())
    assert _equal(opt["master"], ropt["master"]) and _equal(opt["nu"], ropt["nu"])
    assert all(t._host_arena is not None for t in tree_leaves(opt["master"]))
    assert all(not hasattr(t, "_host_arena") for t in tree_leaves(params))


def test_opt_host_restart_from_a_checkpoint_is_exact(tmp_path):
    _, tb = _bundles("olmo-1b")
    tcfg = TrainConfig(remat="none", policy="opt_host",
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
    _, cont = run(state, 3, 3)
    restored, _ = ck.restore({"params": state[0], "opt": state[1], "ef": state[2]})
    _, cont2 = run((restored["params"], restored["opt"], restored["ef"]), 3, 3)
    assert cont == cont2


def test_train_placements_the_step_cannot_realize_raise():
    _, tb = _bundles("olmo-1b")
    gen = torch.Generator().manual_seed(0)
    # the optimizer state takes RESIDENT host placements too
    # (tests/test_torch_resident_host.py), the params both
    # (tests/test_torch_params_host_train.py); the reference's step places
    # neither grads nor activations
    for policy in ("grads=host:stream", "act=host:stream", "grads=host",
                   "params=host:stream,act=host"):
        with pytest.raises(NotImplementedError, match="host roles in training"):
            init_train_state(tb, gen, TrainConfig(policy=policy))
    with pytest.raises(DonorAxisError):
        init_train_state(tb, gen, TrainConfig(policy="opt_peer_host"))
    # the KV-cache role does not exist in training: a serving policy trains as is
    init_train_state(tb, gen, TrainConfig(policy="kv_host"))


def test_launch_train_takes_a_policy(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt-every", "100", "--ckpt-dir", str(tmp_path),
         "--policy", "opt_host"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "training under placement policy opt_host" in res.stderr, res.stderr
    assert "done: 2 steps" in res.stderr, res.stderr
