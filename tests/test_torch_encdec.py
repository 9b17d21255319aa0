"""The encoder-decoder (seamless-m4t-smoke) and the decode-step replay
admission vs the JAX reference.

* ``encdec_defs`` / ``encdec_cache_defs`` and the sizing of a slot;
* ``encode``, ``encdec_train_loss`` (loss, and each gradient leaf at 2e-4
  of its scale, the dense models' grads rule), ``encdec_prefill`` (logits, the self and
  the cross caches), ``encdec_prefill_at`` at ragged offsets with rows
  that write nothing, over a cross cache that prefill filled from nonzero
  frames, and ``encdec_decode_step``, on shared numpy inputs in float32 at
  atol/rtol 1e-4 (``tests/test_torch_model.py``'s ``TOL``);
* the reference ``Server``'s greedy tokens through the port's ``Server``
  under ``hbm_resident``, the RESIDENT host placements, the streamed ones
  (the decoder's windows through ``PlacedDecoderFeed``, the host cross
  KV never written) and preemption;
* the decode-step replay admission of a bundle whose ``prefill_at``
  raises (the reference's ``tests/test_serve_scheduler.py``
  ``TestReplayFallback``): the tokens of chunked admission, the counter,
  one warning;
* the launchers' CPU smokes.
"""

import dataclasses
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import encdec as jencdec
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import warnings_registry
from repro_torch.core.placement import parse_policy
from repro_torch.models import encdec as tencdec
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "seamless-m4t-medium"
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


def _by_path(tree, path=""):
    """{path: leaf} of a nested dict/list tree, keyed as
    ``jax.tree_util.keystr`` keys the reference's leaves (the port keeps
    insertion order, the reference sorts)."""
    if isinstance(tree, dict):
        subs = [(sub, f"{path}[{key!r}]") for key, sub in tree.items()]
    elif isinstance(tree, (list, tuple)):
        subs = [(sub, f"{path}[{i}]") for i, sub in enumerate(tree)]
    else:
        return {path: tree}
    return {k: v for sub, p in subs for k, v in _by_path(sub, p).items()}


def _trees_close(got, want, **kw):
    want = {jax.tree_util.keystr(p): w for p, w in jax.tree_util.tree_leaves_with_path(want)}
    got = _by_path(got)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], **kw)


def _scaled(tree):
    """Each attention projection (encoder, decoder self and cross) scaled
    by 1/sqrt(its fan-in), in a numpy params tree.  The smoke init draws
    the stacked weights at 1/sqrt(stack count) = 1/sqrt(2), so scores
    reach ~140 (std ~32 in the encoder) and every softmax is nearly
    one-hot: it passes f32 rounding residues on ~100x amplified, a cache
    entry of ~20 differing by ~5e-4 between the packages while the logits
    agree to 1e-5.  Scaled, the scores are O(1) and the comparison holds
    the computation, as ``tests/test_torch_mla.py``'s ``deepseek_scaled``
    does."""
    for stack in ("encoder", "decoder"):
        for name, block in tree[stack].items():
            if "w_o" not in block:
                continue
            for w in ("w_q", "w_k", "w_v", "w_o"):
                fan_in = int(np.prod(block[w].shape[1:3])) if w == "w_o" else block[w].shape[1]
                block[w] = (block[w] / np.sqrt(fan_in)).astype(np.float32)
    return tree


def _pair(arch, scale=False):
    """(reference bundle, its params, port bundle, the same params) of an
    arch's smoke config in float32."""
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    tree = jax.tree.map(np.asarray, jb.init_params(jax.random.PRNGKey(0), "float32"))
    if scale:
        tree = _scaled(tree)
    return jb, jax.tree.map(jnp.asarray, tree), tb, convert.params_from_jax(tree, "cpu")


@pytest.fixture(scope="module")
def seamless():
    return _pair(ARCH, scale=True)


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def test_defs_and_sizing_match_reference(seamless):
    jb, _, tb, _ = seamless
    fields = lambda p: (tuple(p.shape), tuple(p.axes), p.init, p.dtype)  # noqa: E731
    is_param = lambda x: hasattr(x, "axes")  # noqa: E731
    for got, want in ((tb.cache_defs(3, 40), jb.cache_defs(3, 40)),
                      (tb.param_defs(), jb.param_defs())):
        want = {jax.tree_util.keystr(p): fields(w) for p, w in
                jax.tree_util.tree_leaves_with_path(want, is_leaf=is_param)}
        assert {k: fields(p) for k, p in _by_path(got).items()} == want
    assert tb.cache_bytes_for(3, 40) == jb.cache_bytes_for(3, 40)
    cache = tb.init_cache(2, 40, device="cpu")
    assert cache["decoder"]["cross"]["k"].shape == (2, 2, 4, 32, 16)
    assert cache["decoder"]["self"]["k"].shape == (2, 2, 4, 40, 16)


def test_encode_matches_reference(seamless):
    jb, jparams, tb, tparams = seamless
    frames = _frames(tb.cfg, 2, 0)
    want = jax.jit(lambda p, f: jencdec.encode(p, f, jb.cfg))(jparams, jnp.asarray(frames))
    _close(tencdec.encode(tparams, _t(frames), tb.cfg), want)


def test_train_loss_and_grads_match_reference(seamless):
    """Loss, ce and aux (0) through the bundle, and every gradient leaf
    (encoder, decoder, the tied embedding) at 2e-4 of its scale."""
    jb, jparams, tb, tparams = seamless
    toks = np.random.default_rng(1).integers(0, jb.cfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "frame_embeds": _frames(tb.cfg, 2, 2)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jb.train_loss(p, jbatch), has_aux=True))(jparams)
    live = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    leaves = tree_leaves(live)
    got, tm = tb.train_loss(live, {k: _t(v) for k, v in batch.items()})
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(tm["ce"], jm["ce"], atol=1e-5, rtol=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    it = iter(torch.autograd.grad(got, leaves))
    grads = tree_map(lambda _: next(it), live)
    want_g = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    got_g = _by_path(grads)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        _close(got_g[k], w, rtol=1e-4, atol=2e-4 * max(float(np.abs(w).max()), 1e-6))
    assert float(got_g["['encoder']['attn']['w_q']"].abs().max()) > 0


def _prefill_both(seamless, B=3, S=10, Smax=48):
    jb, jparams, tb, tparams = seamless
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jb.cfg.vocab, (B, S)).astype(np.int32)
    frames = _frames(tb.cfg, B, 4)
    jlog, jcache = jax.jit(lambda p, b, c: jb.prefill(p, b, c))(
        jparams, {"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(frames)},
        jb.init_cache(B, Smax, "float32"))
    tcache = tb.init_cache(B, Smax, device="cpu")
    tlog, _ = tb.prefill(tparams, {"tokens": _t(toks), "frame_embeds": _t(frames)}, tcache)
    return jlog, jcache, tlog, tcache


def test_prefill_matches_reference(seamless):
    """Logits of the last prompt token and both caches: the self cache's
    first 10 positions, the cross cache projected from the encoded
    frames."""
    jlog, jcache, tlog, tcache = _prefill_both(seamless)
    _close(tlog, jlog)
    _trees_close(tcache, jcache)
    assert float(tcache["decoder"]["cross"]["k"].abs().min()) >= 0
    assert float(tcache["decoder"]["cross"]["v"].abs().max()) > 0.1
    assert not tcache["decoder"]["self"]["k"][:, :, :, 10:].any()


def test_prefill_at_then_decode_match_reference(seamless):
    """After a prefill over nonzero frames: one chunk of 6 at offsets 10,
    10 and 10 writing 4, 0 and 6 positions (the idle row keeps its caches
    bit for bit), a second at ragged offsets, then greedy decode steps at
    each row's own length; logits of the rows that wrote, tokens, and
    both caches (the cross cache read, never written)."""
    jb, jparams, tb, tparams = seamless
    _, jcache, _, tcache = _prefill_both(seamless)
    cross_before = tcache["decoder"]["cross"]["k"].clone()
    idle_before = tcache["decoder"]["self"]["k"][:, 1].clone()
    jpf = jax.jit(lambda p, b, c, o: jb.prefill_at(p, b, c, o))
    jdec = jax.jit(lambda p, b, c: jb.decode_step(p, b, c))
    rng = np.random.default_rng(5)
    offs = np.full(3, 10, np.int32)
    for nl in (np.asarray([4, 0, 6], np.int32), np.asarray([6, 0, 3], np.int32)):
        toks = rng.integers(0, jb.cfg.vocab, (3, 6)).astype(np.int32)
        jlog, jcache = jpf(jparams, {"tokens": jnp.asarray(toks), "new_lens": jnp.asarray(nl)},
                           jcache, jnp.asarray(offs))
        tlog, _ = tb.prefill_at(tparams, {"tokens": _t(toks), "new_lens": _t(nl)}, tcache,
                                _t(offs))
        live = nl > 0
        _close(tlog[torch.from_numpy(live)], np.asarray(jlog)[live])
        offs = offs + nl
    _trees_close(tcache, jcache)
    assert torch.equal(tcache["decoder"]["self"]["k"][:, 1], idle_before)
    assert torch.equal(tcache["decoder"]["cross"]["k"], cross_before)
    tok = rng.integers(0, jb.cfg.vocab, (3, 1)).astype(np.int32)
    for step in range(6):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jnp.asarray(tok),
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _trees_close(tcache, jcache)
    assert torch.equal(tcache["decoder"]["cross"]["k"], cross_before)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

NEW = 8


def _prompts(vocab, lens=(20, 9, 25, 4, 14), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _port_tokens(bundle, tparams, prompts, arrivals=False, **kw):
    server = Server(bundle, ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4, **kw),
                    tparams, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    pending, tick = list(reqs), 0
    while pending or server.has_work():
        while pending and (not arrivals or tick >= 2 * (len(reqs) - len(pending))):
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        assert tick < 3000
    assert all(r.done and len(r.out_tokens) == NEW for r in reqs)
    return server, [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def seamless_tokens(seamless):
    """The reference ``Server``'s greedy tokens (2 slots, chunk 4, max_len
    48): token-only prompts, so each slot's cross KV is zeros."""
    jb, jparams, _, _ = seamless
    server = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=48, prefill_chunk=4),
                       jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(_prompts(jb.cfg.vocab))]
    server.add_requests(reqs)
    server.run_until_done(max_steps=1000)
    assert server.stats()["decode_replay_prefills"] == 0
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("policy", ["hbm_resident", "kv=host", "params=host"])
def test_server_tokens_match_reference(seamless, seamless_tokens, policy):
    """Resident, and RESIDENT in host memory (the cache, the weights): the
    steps read the trees in place through the decoder's feed."""
    _, _, tb, tparams = seamless
    server, got = _port_tokens(tb, tparams, _prompts(tb.cfg.vocab), policy=policy)
    assert server.policy.name == parse_policy(policy).name
    assert server.engine.supports_chunked_prefill
    assert server.stats()["decode_replay_prefills"] == 0
    assert got == seamless_tokens


def test_preempted_tokens_match_reference(seamless, seamless_tokens):
    """Arrivals one every 2 ticks into 2 slots with preemption: a spilled
    slot's self and cross rows park and come back, tokens unchanged."""
    _, _, tb, tparams = seamless
    server, got = _port_tokens(tb, tparams, _prompts(tb.cfg.vocab), arrivals=True,
                               preempt=True, preempt_wait=2, verify_spills=True)
    st = server.stats()
    assert got == seamless_tokens
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    B = 2
    want = sum(t.numel() * t.element_size() // B for t in tree_leaves(server.engine.caches))
    # cache_bytes_for sizes a bf16 cache; this one is float32
    assert server.engine.slot_bytes() == want == 2 * tb.cache_bytes_for(1, 48)


STREAMED = ["kv_host", "weights_stream", "kv=host:stream,params=host:stream"]


@pytest.mark.parametrize("policy", STREAMED)
def test_streamed_placement_tokens_match_reference(seamless, seamless_tokens, policy):
    """The decoder stack streamed from host memory (its weights, its self
    and cross caches, or both) through ``PlacedDecoderFeed``: the
    reference ``Server``'s greedy tokens."""
    _, _, tb, tparams = seamless
    server, got = _port_tokens(tb, tparams, _prompts(tb.cfg.vocab), policy=policy)
    assert server.policy.name == parse_policy(policy).name
    assert server.engine.supports_chunked_prefill
    assert got == seamless_tokens


def _random_cross(server, seed=3):
    """Fill every slot's cross KV with N(0, 1) values (a frontend's
    projection: the token-only prompts leave zeros), in place."""
    gen = torch.Generator().manual_seed(seed)
    for t in tree_leaves(server.engine.caches["decoder"]["cross"]):
        t.copy_(torch.randn(t.shape, generator=gen))


@pytest.mark.parametrize("policy,streams", [
    ("kv_host", {"kv_cache": 2}),
    ("weights_stream", {"params": 4}),
    ("kv=host:stream,params=host:stream", {"kv_cache": 2, "params": 4}),
])
def test_streamed_cross_kv_is_read_and_never_written(seamless, policy, streams):
    """Over a cross KV of random values, a streamed server's tokens equal
    ``hbm_resident``'s, and after every prefill dispatch and decode step
    the host cross entries are unchanged, bit for bit: only the self rows
    go back.  The windows and their bytes: one cache window a decoder layer
    (self and cross), the embedding, each decoder layer and the tail
    (final norm, the tied embedding again) of weights; the encoder's
    params in none."""
    _, _, tb, tparams = seamless
    runs = {}
    for pol in ("hbm_resident", policy):
        server = Server(tb, ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4,
                                        policy=pol), tparams, device="cpu")
        _random_cross(server)
        cross = tree_leaves(server.engine.caches["decoder"]["cross"])
        before = [t.clone() for t in cross]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW)
                for i, p in enumerate(_prompts(tb.cfg.vocab))]
        for r in reqs:
            server.add_request(r)
        while server.has_work():
            server.step()
            assert all(torch.equal(a, b) for a, b in zip(before, cross))
        runs[pol] = (server, [r.out_tokens for r in reqs])
    assert runs[policy][1] == runs["hbm_resident"][1]
    server = runs[policy][0]
    st = server.stats()
    assert st["prefill_dispatches"] > 0 and st["decode_steps"] > 0
    feed = server.engine.feed
    assert {name: s.n_windows for name, s in feed.streams().items()} == streams
    assert tb.cfg.n_layers == 2
    p = server.params
    want = {"params": sum(t.numel() * 4 for t in tree_leaves(p))
            - sum(t.numel() * 4 for t in tree_leaves(p["encoder"]))
            - sum(t.numel() * 4 for t in tree_leaves(p["enc_final_norm"]))
            + sum(t.numel() * 4 for t in tree_leaves(p["embed"])),
            "kv_cache": sum(t.numel() * 4 for t in tree_leaves(server.engine.caches))}
    assert {name: sum(s.window_bytes) for name, s in feed.streams().items()} == {
        name: want[name] for name in streams}
    assert feed.h2d_bytes() == sum(want[name] for name in streams)
    assert feed.d2h_bytes() == 0           # the self rows go back through the kernel
    assert server.engine.audit_allowance("decode") == 3 * 2 * 4 + feed.h2d_bytes()


@pytest.mark.parametrize("policy", ["kv_host", "weights_stream"])
def test_streamed_placement_is_refused(seamless, policy):
    """A streamed placement serves (above), but the whole-prompt prefill
    from position 0, which reads the encoder's params and writes the cross
    cache, does not run through its feed."""
    _, _, tb, tparams = seamless
    server = Server(tb, ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4,
                                    policy=policy), tparams, device="cpu")
    frames = torch.from_numpy(_frames(tb.cfg, 2, 0))
    with pytest.raises(ValueError, match="does not run through a PlacedFeed"):
        tb.prefill(server.params, {"frame_embeds": frames,
                                   "tokens": torch.ones((2, 3), dtype=torch.int32)},
                   server.engine.caches, feed=server.engine.feed)


class _NoChunkBundle:
    """A bundle whose ``prefill_at`` raises ``NotImplementedError``: the
    kind of bundle the decode-step replay admission is for."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def prefill_at(self, *args, **kwargs):
        raise NotImplementedError


@pytest.mark.parametrize("arch", [ARCH, "yi-6b"])
def test_replay_admission_warns_once_counts_and_matches(arch, caplog):
    """Admission by decode-step replay: the tokens of chunked admission
    (the reference ``Server``'s), ``decode_replay_prefills`` one per
    admitted request, one warning ever, and no prefill dispatch."""
    jb, jparams, tb, tparams = _pair(arch)
    prompts = _prompts(tb.cfg.vocab)
    _, want = _port_tokens(tb, tparams, prompts)
    warnings_registry.reset_warnings("decode_replay")
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve.engine"):
        server, got = _port_tokens(_NoChunkBundle(tb), tparams, prompts)
        again, _ = _port_tokens(_NoChunkBundle(tb), tparams, prompts[:2])
    assert got == want
    assert not server.engine.supports_chunked_prefill
    st = server.stats()
    assert st["decode_replay_prefills"] == len(prompts)
    assert again.stats()["decode_replay_prefills"] == 2
    assert st["prefill_dispatches"] == 0
    warns = [r for r in caplog.records if "decode-step replay" in r.getMessage()]
    assert len(warns) == 1, "the replay warning fires once"
    if arch == ARCH:
        jserver = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=48, prefill_chunk=4),
                            jparams)
        reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
        jserver.add_requests(reqs)
        jserver.run_until_done(max_steps=1000)
        assert got == [r.out_tokens for r in reqs]


def test_chunked_bundle_never_counts_replay(seamless):
    _, _, tb, tparams = seamless
    server, _ = _port_tokens(tb, tparams, _prompts(tb.cfg.vocab)[:1])
    assert server.engine.supports_chunked_prefill
    assert server.stats()["decode_replay_prefills"] == 0


@pytest.mark.parametrize("launcher,args,said", [
    ("serve", ["--requests", "3", "--slots", "2", "--max-len", "48",
               "--prefill-chunk", "4"], "served 3 requests"),
    ("train", ["--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
               "--ckpt-every", "100"], "done: 2 steps"),
])
def test_launchers_seamless_cpu_smoke(launcher, args, said, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    extra = ["--ckpt-dir", str(tmp_path)] if launcher == "train" else []
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", ARCH, "--smoke",
         "--device", "cpu", *args, *extra],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert said in res.stdout + res.stderr, res.stdout + res.stderr
