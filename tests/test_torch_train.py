"""The port's training path vs the JAX reference's, on the CPU.

Weights and optimizer state come from the reference (``init_params`` /
``init_train_state``) and are carried across with ``repro_torch.convert``;
batches are numpy arrays from the same seed, fed to both.  Models are
yi-6b-smoke (GQA, G = 8) and olmo-1b-smoke (G = 1, non-parametric LN) in
float32, where the port takes its plain attention path.

Tolerances: 1e-4 for one forward/backward (f32 sums in another order),
with gradients held per leaf (see :func:`_grads_close`); after AdamW
steps see :func:`test_train_steps_match_reference`.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.mesh import make_mesh_for
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["yi-6b", "olmo-1b", "granite-8b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), **(kw or TOL)
    )


def _bundles(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    return JaxBundle(jcfg), ModelBundle(tcfg)


def _weights(arch):
    jb, tb = _bundles(arch)
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, tb, jparams, tparams


def _batch(vocab, B=2, S=16, seed=0):
    data = SyntheticLM(DataConfig(vocab=vocab, seq_len=S, global_batch=B, seed=seed))
    return next(data)


def _tree_close(got, want, **kw):
    """Every leaf of the port's tree against the reference's leaf at the
    same path (dict entries by key)."""
    tree_map(lambda g, w: _close(g, w, **kw), got, want)


def _grads_close(got, want):
    """Gradients leaf by leaf, with atol 2e-4 x the leaf's largest |value|.

    olmo's non-parametric LN over 0.02-scale embeddings scales rounding
    noise by 1/std ~ 50 into the input-embedding rows (|grad| up to 2.3
    there, against ~1e-3 elsewhere).  Against a float64 run of the port,
    both f32 gradients are off by ~1e-4 of that scale (port 7.6e-5,
    reference 1.9e-4 on the worst row), so they can differ by ~1.2e-4 x
    scale from each other.
    """
    tree_map(lambda g, w: _close(g, w, rtol=1e-4,
                                 atol=2e-4 * max(float(np.abs(w).max()), 1e-6)),
             got, want)


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 8, 97)).astype(np.float32) * 3
    labels = rng.integers(0, 97, (2, 8)).astype(np.int32)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tlayers.cross_entropy(_t(logits), _t(labels))
    _close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("S,block", [(16, 512), (24, 8), (24, 16)])
def test_fused_cross_entropy_matches_reference(S, block, tied):
    """Value and gradients (hidden states and head) through the per-slab
    recompute; block 8 over 24 positions gives 3 slabs, block 16 does not
    divide 24 and falls back to one slab, as the reference does."""
    rng = np.random.default_rng(S + block)
    d, V = 32, 101
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    labels = rng.integers(0, V, (2, S)).astype(np.int32)
    w = rng.normal(size=(V, d) if tied else (d, V)).astype(np.float32) * 0.2
    head, emb = ({}, {"embedding": w}) if tied else ({"unembed": w}, {})

    def jloss(x, w):
        h, e = ({}, {"embedding": w}) if tied else ({"unembed": w}, {})
        return jlayers.fused_cross_entropy(h, e, x, jnp.asarray(labels), block=block)

    want, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    head, emb = ({}, {"embedding": tw}) if tied else ({"unembed": tw}, {})
    got = tlayers.fused_cross_entropy(head, emb, tx, _t(labels), block=block)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    _close(got, want, atol=1e-6, rtol=1e-6)
    _close(gx, jgx, atol=1e-6, rtol=1e-5)
    _close(gw, jgw, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model's training and prefill entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits_match_reference(arch):
    jb, tb, jparams, tparams = _weights(arch)
    toks = _batch(jb.cfg.vocab)["tokens"]
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks), jb.cfg, remat="none")
    got, aux = ttf.lm_forward(tparams, _t(toks), tb.cfg, remat="none")
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, remat):
    jb, tb, jparams, tparams = _weights(arch)
    batch = _batch(jb.cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jgrads = jax.value_and_grad(
        lambda p: jb.train_loss(p, jbatch, remat=remat),
        has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    got, tm = tb.train_loss(tparams, {k: _t(v) for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(got, leaves)
    it = iter(grads)
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(tm["ce"], jm["ce"], atol=1e-5, rtol=1e-5)
    _grads_close(tree_map(lambda _: next(it), tparams), jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_matches_reference(arch):
    jb, tb, jparams, tparams = _weights(arch)
    toks = _batch(jb.cfg.vocab, B=3, S=12)["tokens"]
    jlogits, jcache = jb.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 jb.init_cache(3, 20, "float32"))
    tcache = tb.init_cache(3, 20, dtype="float32", device="cpu")
    tlogits, same = tb.prefill(tparams, {"tokens": _t(toks)}, tcache)
    assert same is tcache                          # filled in place
    _close(tlogits, jlogits)
    _tree_close(tcache, jcache)
    # positions past the prompt stay zero, as in the reference
    assert all(float(t[:, :, :, 12:].abs().max()) == 0 for t in tree_leaves(tcache))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_train(arch, steps, lr, warmup):
    """The reference's state and per-step (loss, grad_norm, params)."""
    jb, _ = _bundles(arch)
    mesh = make_mesh_for((1,), ("data",))
    tcfg = JaxTrainConfig(remat="full",
                          optimizer=JaxAdamWConfig(lr=lr, warmup_steps=warmup))
    params, opt, ef = jax_init_train_state(jb, mesh, jax.random.PRNGKey(0), tcfg)
    start = jax.tree.map(np.asarray, (params, opt, ef))
    step = jax.jit(jax_make_train_step(jb, mesh, tcfg))
    data = JaxSyntheticLM(JaxDataConfig(vocab=jb.cfg.vocab, seq_len=16, global_batch=4))
    out = []
    for _ in range(steps):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, opt, ef, m = step(params, opt, ef, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    jax.tree.map(np.asarray, params)))
    return start, out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """3 AdamW steps from the reference's own initial state, carried across.

    Step 1's loss starts from identical weights (1e-5).  Each step moves a
    weight by at most lr_t (1 + weight decay |w|): Adam's m / sqrt(v) turns
    a near-zero gradient's rounding difference into a step of up to lr_t
    either way, so a weight may differ by up to 2 x the summed lr_t — the
    bound held for every weight.  Nearly all weights differ by far less:
    the 99th percentile is held to 1e-5, two orders below that bound.
    """
    lr, warmup, steps = 1e-3, 2, 3
    (jparams, jopt, jef), ref_steps = _jax_train(arch, steps, lr, warmup)
    _, tb = _bundles(arch)
    params, opt = convert.params_from_jax((jparams, jopt), "cpu")
    step = make_train_step(tb, TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=lr, warmup_steps=warmup)))
    data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=16, global_batch=4))
    lr_sum = 0.0
    for i, (jloss, jgnorm, jp) in enumerate(ref_steps):
        batch = {k: _t(v) for k, v in next(data).items()}
        params, opt, _, m = step(params, opt, None, batch)
        lr_sum += lr * min((i + 1) / warmup, 1.0)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), jgnorm, rtol=1e-4)
        diffs = []
        tree_map(lambda g, w: diffs.append(np.abs(g.numpy() - w).ravel()), params, jp)
        diffs = np.concatenate(diffs)
        assert diffs.max() <= 2 * lr_sum * 1.1, (i, diffs.max())
        assert np.quantile(diffs, 0.99) <= 1e-5, (i, np.quantile(diffs, 0.99))
    assert int(opt["step"]) == steps and opt["step"].dtype == torch.int32


def test_params_from_jax_carries_a_train_state():
    """params (bf16), the f32 master and moments, and the int32 step."""
    jb, tb = _bundles("olmo-1b", dtype="bfloat16")
    mesh = make_mesh_for((1,), ("data",))
    params, opt, _ = jax_init_train_state(jb, mesh, jax.random.PRNGKey(0),
                                          JaxTrainConfig())
    opt = dict(opt, step=jnp.asarray(7, jnp.int32))
    tp, to = convert.params_from_jax(jax.tree.map(np.asarray, (params, opt)), "cpu")
    assert to["step"].dtype == torch.int32 and to["step"].shape == () and int(to["step"]) == 7
    assert {t.dtype for t in tree_leaves(tp)} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(to["master"])} == {torch.float32}
    _tree_close(tp, params, atol=0, rtol=0)
    _tree_close(to["master"], opt["master"], atol=0, rtol=0)
    ours = init_opt_state(tp)
    _tree_close(ours["master"], opt["master"], atol=0, rtol=0)
    _tree_close(ours["nu"], opt["nu"], atol=0, rtol=0)


@pytest.mark.parametrize("cfg", [
    dict(vocab=512, seq_len=16, global_batch=4),
    dict(vocab=50304, seq_len=33, global_batch=3, seed=5, structure=0.5),
])
def test_synthetic_lm_batches_are_bit_identical(cfg):
    ours = SyntheticLM(DataConfig(**cfg))
    theirs = JaxSyntheticLM(JaxDataConfig(**cfg))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    ours.restore({"step": 7, "seed": cfg.get("seed", 0)})
    theirs.restore({"step": 7, "seed": cfg.get("seed", 0)})
    assert np.array_equal(next(ours)["tokens"], next(theirs)["tokens"])
    shard = SyntheticLM(DataConfig(**cfg), process_index=1, process_count=cfg["global_batch"])
    jshard = JaxSyntheticLM(JaxDataConfig(**cfg), process_index=1,
                            process_count=cfg["global_batch"])
    assert np.array_equal(next(shard)["labels"], next(jshard)["labels"])


def test_prefetcher_yields_the_stream_and_closes():
    cfg = DataConfig(vocab=512, seq_len=8, global_batch=2)
    it = Prefetcher(SyntheticLM(cfg), depth=2)
    try:
        got = [next(it) for _ in range(3)]
    finally:
        it.close(timeout=5.0)
    assert not it._thread.is_alive()
    want = SyntheticLM(cfg)
    for g in got:
        assert np.array_equal(g["tokens"], next(want)["tokens"])


def test_train_config_refuses_what_needs_a_mesh():
    for kw in (dict(rules={"batch": "data"}), dict(fsdp_axes=("pod", "data")),
               dict(zero_stage=1), dict(compress_pod_grads=True)):
        with pytest.raises(NotImplementedError, match="A9"):
            make_train_step(None, TrainConfig(**kw))


# ---------------------------------------------------------------------------
# port-only behaviour the reference's system tests check
# ---------------------------------------------------------------------------

def _train(bundle, steps, start_state=None, data_start=0, lr=3e-3):
    tcfg = TrainConfig(remat="none",
                       optimizer=AdamWConfig(lr=lr, warmup_steps=5, weight_decay=0.0))
    if start_state is None:
        start_state = init_train_state(bundle, torch.Generator().manual_seed(0), tcfg)
    params, opt, ef = start_state
    step = make_train_step(bundle, tcfg)
    data = SyntheticLM(DataConfig(vocab=bundle.cfg.vocab, seq_len=32, global_batch=8,
                                  structure=1.0))
    data.restore({"step": data_start, "seed": 0})
    losses = []
    for _, batch in zip(range(steps), data):
        params, opt, ef, m = step(params, opt, ef, {k: _t(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return (params, opt, ef), losses


def test_checkpoint_restart_exact(tmp_path):
    bundle = ModelBundle(smoke_config("olmo-1b"))
    state, _ = _train(bundle, steps=6)
    ck = Checkpointer(str(tmp_path))
    ck.save(6, state, blocking=True)
    _, cont = _train(bundle, steps=4, start_state=state, data_start=6)
    restored, manifest = ck.restore(state)
    assert manifest["step"] == 6
    _, cont2 = _train(bundle, steps=4, start_state=tuple(restored), data_start=6)
    np.testing.assert_allclose(cont, cont2, rtol=1e-5, atol=1e-6)


def test_microbatched_matches_full_batch():
    """As the reference's system test: the loss and the accumulated
    gradient's norm, not post-Adam params (Adam's first step amplifies
    bf16 accumulation-order noise on near-zero grads)."""
    bundle = ModelBundle(smoke_config("olmo-1b"))
    batch = {k: _t(v) for k, v in _batch(bundle.cfg.vocab, B=8).items()}
    out = {}
    for n in (1, 4):
        tcfg = TrainConfig(remat="none", n_microbatches=n,
                           optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
        p, o, e = init_train_state(bundle, torch.Generator().manual_seed(0), tcfg)
        out[n] = make_train_step(bundle, tcfg)(p, o, e, batch)[3]
    np.testing.assert_allclose(float(out[1]["loss"]), float(out[4]["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(out[1]["grad_norm"]), float(out[4]["grad_norm"]),
                               rtol=1e-2)


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reference's Checkpointer writes a bf16 train state with its
    compression error feedback; the port restores it bit for bit into its
    own template, int32 step included."""
    jb, tb = _bundles("olmo-1b", dtype="bfloat16")
    mesh = make_mesh_for((1,), ("data",))
    params, opt, ef = jax_init_train_state(jb, mesh, jax.random.PRNGKey(3),
                                           JaxTrainConfig())
    opt = dict(opt, step=jnp.asarray(5, jnp.int32))
    JaxCheckpointer(str(tmp_path)).save(5, {"params": params, "opt": opt, "ef": ef},
                                        extra={"data": {"step": 5, "seed": 0}},
                                        blocking=True)
    tp, to, tef = init_train_state(tb, torch.Generator().manual_seed(0), TrainConfig())
    restored, manifest = Checkpointer(str(tmp_path)).restore(
        {"params": tp, "opt": to, "ef": tef})
    assert manifest["extra"]["data"] == {"step": 5, "seed": 0}
    assert restored["params"]["embed"]["embedding"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 5
    _tree_close(restored["params"], params, atol=0, rtol=0)
    _tree_close(restored["opt"], opt, atol=0, rtol=0)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jb, tb = _bundles("olmo-1b", dtype="bfloat16")
    params, opt, ef = init_train_state(tb, torch.Generator().manual_seed(1), TrainConfig())
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"params": params, "opt": opt, "ef": ef})       # async write
    ck.wait()
    mesh = make_mesh_for((1,), ("data",))
    jp, jo, je = jax_init_train_state(jb, mesh, jax.random.PRNGKey(0), JaxTrainConfig())
    restored, _ = JaxCheckpointer(str(tmp_path)).restore(
        {"params": jp, "opt": jo, "ef": je})
    assert restored["params"]["embed"]["embedding"].dtype == jnp.bfloat16
    _tree_close(params, restored["params"], atol=0, rtol=0)
    _tree_close(opt, restored["opt"], atol=0, rtol=0)


def test_supervisor_restores_after_a_failed_step(tmp_path):
    """A step that fails after a checkpoint is restored and replayed; the
    restart is counted."""
    bundle = ModelBundle(smoke_config("olmo-1b"))
    tcfg = TrainConfig(remat="none", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    params, opt, ef = init_train_state(bundle, torch.Generator().manual_seed(0), tcfg)
    step = make_train_step(bundle, tcfg)
    data = SyntheticLM(DataConfig(vocab=bundle.cfg.vocab, seq_len=16, global_batch=2))
    calls = {"n": 0}

    def one(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected failure")
        p, o, e, m = step(state["params"], state["opt"], state["ef"],
                          {k: _t(v) for k, v in batch.items()})
        return {"params": p, "opt": o, "ef": e}, m

    sup = Supervisor(Checkpointer(str(tmp_path)), SupervisorConfig(checkpoint_every=2))
    state, done = sup.run({"params": params, "opt": opt, "ef": ef}, one, data, 4,
                          extra_state=lambda: {"data": data.state()})
    assert done == 4 and sup.restarts == 1
    assert int(state["opt"]["step"]) == 4


def test_launch_train_cpu_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "done: 3 steps" in res.stderr and "restarts 0" in res.stderr, res.stderr
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
