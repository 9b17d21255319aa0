"""The vision-stub VLM (internvl2-smoke) vs the JAX reference.

* ``frontend_input_defs`` / ``frontend_embeds`` and the bundle's input
  defs (the text is ``S - frontend_tokens`` long in train and prefill
  batches, the patch embeddings beside it);
* ``lm_loss`` with ``patch_embeds`` (loss, and each gradient leaf at 2e-4
  of its scale, the dense models' grads rule) under the port's three remat modes;
  ``lm_prefill`` with ``patch_embeds`` (logits and the caches, patch and
  text positions), then text-only ``lm_prefill_at`` and decode steps on
  those caches, in float32 at atol/rtol 1e-4;
* the reference ``Server``'s greedy tokens (token-only prompts) through
  the port's ``Server``, with and without preemption;
* the launchers' CPU smokes.
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

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.multimodal import frontend_embeds, frontend_input_defs
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internvl2-1b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread runs them as fast and leaves the
    cores to the suite's other processes.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), **(kw or TOL)
    )


def _caches_close(tcache, jcache):
    jl, tl = jax.tree.leaves(jcache), tree_leaves(tcache)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.fixture(scope="module")
def internvl():
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(ARCH), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(ARCH), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _patches(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("smoke", [True, False])
def test_input_defs_match_reference(smoke):
    """The batch inputs of every shape: tokens (and labels) of S -
    frontend_tokens, ``patch_embeds`` of (B, frontend_tokens, d)."""
    from repro.configs import get_config as jax_get_config

    tb = ModelBundle(smoke_config(ARCH) if smoke else get_config(ARCH))
    jb = JaxBundle(jax_smoke_config(ARCH) if smoke else jax_get_config(ARCH))
    for name, shape in SHAPES.items():
        got = {k: (p.shape, p.axes, p.dtype) for k, p in tb.input_defs(shape).items()}
        want = {k: (p.shape, p.axes, p.dtype)
                for k, p in jb.input_defs(JAX_SHAPES[name]).items()}
        assert got == want, name
    cfg = tb.cfg
    (key, p), = frontend_input_defs(cfg, 3).items()
    assert key == "patch_embeds" and p.shape == (3, cfg.frontend_tokens, cfg.d_model)
    assert frontend_input_defs(smoke_config("yi-6b"), 3) == {}
    assert frontend_embeds({"tokens": 0}) is None
    assert frontend_embeds({"tokens": 0, "patch_embeds": 7}) == 7


@pytest.fixture(scope="module")
def vlm_loss(internvl):
    """A batch of 2 x 20 text tokens behind 16 patches, and the reference's
    loss, metrics and gradients, once."""
    jb, jparams, _, _ = internvl
    toks = np.random.default_rng(1).integers(0, jb.cfg.vocab, (2, 20)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "patch_embeds": _patches(jb.cfg, 2, 2)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jb.train_loss(p, jbatch, remat="none"), has_aux=True))(jparams)
    return batch, want, jm, jgrads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_with_patches_match_reference(internvl, vlm_loss, remat):
    """The loss over the text positions only (the patches' hidden states
    dropped before the head), and every gradient, the embedding's included
    (the patches reach it through attention, not through a lookup)."""
    _, _, tb, tparams = internvl
    batch, want, jm, jgrads = vlm_loss
    live = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    leaves = tree_leaves(live)
    got, tm = tb.train_loss(live, {k: _t(v) for k, v in batch.items()}, remat=remat)
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(tm["ce"], jm["ce"], atol=1e-5, rtol=1e-5)
    it = iter(torch.autograd.grad(got, leaves))
    tree_map(lambda g, w: _close(g, w, rtol=1e-4,
                                 atol=2e-4 * max(float(np.abs(w).max()), 1e-6)),
             tree_map(lambda _: next(it), live), jgrads)


def test_patches_change_the_loss(internvl, vlm_loss):
    """The patch embeddings are read: other patches, another loss."""
    _, _, tb, tparams = internvl
    batch, want, _, _ = vlm_loss
    other = dict(batch, patch_embeds=_patches(tb.cfg, 2, 9))
    got, _ = tb.train_loss(tparams, {k: _t(v) for k, v in other.items()})
    assert abs(float(got) - float(want)) > 1e-4


def test_prefill_with_patches_then_text_match_reference(internvl):
    """``prefill`` of 16 patches + 9 prompt tokens (logits, caches: 25
    positions), then a text chunk at ragged offsets (one row idle) and
    greedy decode steps on those caches."""
    jb, jparams, tb, tparams = internvl
    B, S, Smax = 3, 9, 64
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jb.cfg.vocab, (B, S)).astype(np.int32)
    patches = _patches(tb.cfg, B, 4)
    jlog, jcache = jax.jit(lambda p, b, c: jb.prefill(p, b, c))(
        jparams, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
        jb.init_cache(B, Smax, "float32"))
    tcache = tb.init_cache(B, Smax, device="cpu")
    tlog, _ = tb.prefill(tparams, {"tokens": _t(toks), "patch_embeds": _t(patches)}, tcache)
    _close(tlog, jlog)
    _caches_close(tcache, jcache)
    front = tb.cfg.frontend_tokens
    filled = tcache["stages"][0]["0F"]["k"]
    assert filled[:, :, :, :front + S].abs().amax() > 0
    assert not filled[:, :, :, front + S:].any()
    jpf = jax.jit(lambda p, b, c, o: jb.prefill_at(p, b, c, o))
    jdec = jax.jit(lambda p, b, c: jb.decode_step(p, b, c))
    offs = np.full(B, front + S, np.int32)
    nl = np.asarray([5, 0, 3], np.int32)
    chunk = rng.integers(0, jb.cfg.vocab, (B, 5)).astype(np.int32)
    jlog, jcache = jpf(jparams, {"tokens": jnp.asarray(chunk), "new_lens": jnp.asarray(nl)},
                       jcache, jnp.asarray(offs))
    tlog, _ = tb.prefill_at(tparams, {"tokens": _t(chunk), "new_lens": _t(nl)}, tcache,
                            _t(offs))
    live = nl > 0
    _close(tlog[torch.from_numpy(live)], np.asarray(jlog)[live])
    offs = offs + nl
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for step in range(6):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jnp.asarray(tok),
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

NEW = 8


def _prompts(vocab, lens=(20, 9, 25, 4, 14), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def internvl_tokens(internvl):
    jb, jparams, _, _ = internvl
    server = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=48, prefill_chunk=4),
                       jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(_prompts(jb.cfg.vocab))]
    server.add_requests(reqs)
    server.run_until_done(max_steps=1000)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("preempt", [False, True], ids=["plain", "preempted"])
def test_server_tokens_match_reference(internvl, internvl_tokens, preempt):
    """Token-only prompts through the port's ``Server`` (arrivals one every
    2 ticks with preemption in the second case): the reference's tokens."""
    _, _, tb, tparams = internvl
    kw = dict(preempt=True, preempt_wait=2, verify_spills=True) if preempt else {}
    server = Server(tb, ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4, **kw),
                    tparams, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(_prompts(tb.cfg.vocab))]
    pending, tick = list(reqs), 0
    while pending or server.has_work():
        while pending and (not preempt or tick >= 2 * (len(reqs) - len(pending))):
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        assert tick < 3000
    assert [r.out_tokens for r in reqs] == internvl_tokens
    st = server.stats()
    assert st["decode_replay_prefills"] == 0
    if preempt:
        assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]


@pytest.mark.parametrize("launcher,args,said", [
    ("serve", ["--requests", "3", "--slots", "2", "--max-len", "48",
               "--prefill-chunk", "4"], "served 3 requests"),
    ("train", ["--steps", "2", "--batch", "2", "--seq", "24", "--log-every", "1",
               "--ckpt-every", "100"], "done: 2 steps"),
])
def test_launchers_internvl_cpu_smoke(launcher, args, said, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    extra = ["--ckpt-dir", str(tmp_path)] if launcher == "train" else []
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", ARCH, "--smoke",
         "--device", "cpu", *args, *extra],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert said in res.stdout + res.stderr, res.stdout + res.stderr


@pytest.mark.parametrize("extra", [0, -1])
def test_train_launcher_rejects_seq_without_text(extra):
    """A VLM's --seq must leave text after its patches."""
    from repro_torch.launch.train import parse_args, train

    F = smoke_config(ARCH).frontend_tokens
    args = parse_args(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                       "--batch", "1", "--seq", str(F + extra)])
    with pytest.raises(SystemExit, match="leaves no text"):
        train(args)
