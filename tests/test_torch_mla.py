"""Absorbed MLA attention and deepseek-v2-smoke vs the JAX reference.

* ``mla_train``, ``mla_prefill``, ``mla_prefill_at`` and ``mla_decode``
  (outputs and latent caches) with and without ``q_lora``, on shared numpy
  inputs, float32 at atol/rtol 1e-4; ``mla_decode`` in bfloat16 at 5e-2
  (the kernels' bf16 limit, ``tests/test_torch_kernels.py``);
* ``_append_latent``'s drops: entries past ``new_lens`` dropped, rows
  with ``new_lens == 0`` kept bit for bit, writes past the cache clamped
  to its last slot as the reference's scatter leaves them (equal);
* deepseek-v2-smoke (MLA on both layers, layer 0 dense, layer 1 MoE: 8
  experts top-2 + 1 shared) in float32 through ``ModelBundle``: prefill,
  ``prefill_at`` and decode logits and caches at 1e-4
  (``tests/test_torch_moe.py``), the loss, ce, aux and grads under remat
  ``none``/``full``/``dots`` (each gradient leaf at 2e-4 of its scale, on
  weights whose attention projections are scaled to keep the softmax off
  one-hot: ``deepseek_scaled``),
  and the reference ``Server``'s greedy tokens under four placements and
  with preemption; the launchers' CPU smokes.

As in ``tests/test_torch_moe.py``, routing couples the rows of a step, so
the preemption test, whose schedule reads wall time, runs under a capacity
that holds every token.
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

from repro.configs import AttentionSpec as JaxSpec
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import AttentionSpec, smoke_config
from repro_torch.core.placement import parse_policy
from repro_torch.models import attention as tattn
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's shapes are tiny: one intra-op thread runs them as fast,
    and leaves the cores to the other test processes (the suite runs in
    several).  Restored after the module."""
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


# ---------------------------------------------------------------------------
# the MLA functions against the reference's
# ---------------------------------------------------------------------------

D_MODEL, SMAX = 32, 16


def _spec(q_lora):
    kw = dict(n_heads=4, n_kv_heads=4, d_head=24, kind="mla", q_lora=q_lora,
              kv_lora=16, rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    return AttentionSpec(**kw), JaxSpec(**kw)


def _mla_case(q_lora, seed=0, B=3, S=6):
    """Both specs, params (numpy f32, each weight at 1/sqrt(fan-in)), x
    and a latent cache whose slots hold earlier positions' values."""
    tspec, jspec = _spec(q_lora)
    rng = np.random.default_rng(seed)

    def draw(name, p):
        fan_in = int(np.prod(p.shape[:2])) if name == "w_o" else p.shape[0]
        return (rng.normal(size=p.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = {k: draw(k, p) for k, p in tattn.attention_defs(D_MODEL, tspec).items()}
    x = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    cache = {"ckv": rng.normal(size=(B, SMAX, 16)).astype(np.float32),
             "krope": rng.normal(size=(B, SMAX, 8)).astype(np.float32)}
    return tspec, jspec, params, x, cache


def _both(params, x, cache=None, dtype="float32"):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tp = {k: _t(v).to(tdt) for k, v in params.items()}
    out = (jp, jnp.asarray(x).astype(jdt), tp, _t(x).to(tdt))
    if cache is not None:
        out += ({k: jnp.asarray(v).astype(jdt) for k, v in cache.items()},
                {k: _t(v).to(tdt) for k, v in cache.items()})
    return out


def _cache_equalish(tcache, jcache, **kw):
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name], **(kw or TOL))


def test_mla_defs_match_reference():
    for q_lora in (0, 24):
        tspec, jspec = _spec(q_lora)
        got = tattn.attention_defs(D_MODEL, tspec)
        want = jattn.attention_defs(D_MODEL, jspec)
        fields = lambda p: (tuple(p.shape), tuple(p.axes), p.init, p.dtype)  # noqa: E731
        assert {k: fields(p) for k, p in got.items()} == {
            k: fields(p) for k, p in want.items()}
        assert ("w_q_a" in got) == bool(q_lora) and ("w_q" in got) != bool(q_lora)
        assert {k: fields(p) for k, p in tattn.cache_defs(2, SMAX, tspec).items()} == {
            k: fields(p) for k, p in jattn.cache_defs(2, SMAX, jspec).items()}


@pytest.mark.parametrize("q_lora", [0, 24], ids=["no_q_lora", "q_lora"])
def test_mla_train_and_prefill_match_reference(q_lora):
    """Full-sequence attention (q/k head dim 24, v 16) and the prefill that
    fills the latent cache from position 0."""
    tspec, jspec, params, x, _ = _mla_case(q_lora)
    jp, jx, tp, tx = _both(params, x)
    _close(tattn.mla_train(tp, tx, tspec), jattn.mla_train(jp, jx, jspec))
    B = x.shape[0]
    jcache = jattn.cache_defs(B, SMAX, jspec)
    jcache = {k: jnp.zeros(p.shape, jnp.float32) for k, p in jcache.items()}
    tcache = {k: torch.zeros(p.shape) for k, p in tattn.cache_defs(B, SMAX, tspec).items()}
    jout, jcache = jattn.mla_prefill(jp, jx, jcache, jspec)
    tout = tattn.mla_prefill(tp, tx, tcache, tspec)
    _close(tout, jout)
    _cache_equalish(tcache, jcache)
    assert not tcache["ckv"][:, x.shape[1]:].any()


@pytest.mark.parametrize("q_lora", [0, 24], ids=["no_q_lora", "q_lora"])
def test_mla_prefill_at_then_decode_match_reference(q_lora):
    """One chunk of 6 at offsets 3, 0 and 13 (writing 5, 0 and 6 entries:
    the last row runs past the 16 slots and clamps), then two decode steps,
    the second at a length past the cache.  Every row's output (an idle
    row's too: the same function of its queries) and the caches."""
    tspec, jspec, params, x, cache = _mla_case(q_lora, seed=1)
    jp, jx, tp, tx, jcache, tcache = _both(params, x, cache)
    offs, nl = np.asarray([3, 0, 13], np.int32), np.asarray([5, 0, 6], np.int32)
    jout, jcache = jattn.mla_prefill_at(jp, jx, jcache, jnp.asarray(offs), jnp.asarray(nl),
                                        jspec)
    tout = tattn.mla_prefill_at(tp, tx, tcache, _t(offs), _t(nl), tspec)
    _close(tout, jout)
    _cache_equalish(tcache, jcache)
    np.testing.assert_array_equal(tcache["ckv"][1].numpy(), cache["ckv"][1])
    rng = np.random.default_rng(2)
    for lengths in ([8, 0, 15], [9, 1, 18]):
        xd = rng.normal(size=(3, 1, D_MODEL)).astype(np.float32)
        L = np.asarray(lengths, np.int32)
        jout, jcache = jattn.mla_decode(jp, jnp.asarray(xd), jcache, jnp.asarray(L), jspec)
        tout = tattn.mla_decode(tp, _t(xd), tcache, _t(L), tspec)
        _close(tout, jout)
        _cache_equalish(tcache, jcache)


def test_append_latent_drops_as_the_reference():
    """Entries past ``new_lens`` are dropped, a row with ``new_lens == 0``
    keeps its cache bit for bit, and entries past the cache land on its
    last slot, the last kept one winning: equal to the reference."""
    rng = np.random.default_rng(3)
    B, S = 5, 7
    cache = {"ckv": rng.normal(size=(B, SMAX, 4)).astype(np.float32),
             "krope": rng.normal(size=(B, SMAX, 2)).astype(np.float32)}
    ckv = rng.normal(size=(B, S, 4)).astype(np.float32)
    kr = rng.normal(size=(B, S, 2)).astype(np.float32)
    offs = np.asarray([0, 4, 12, 15, 20], np.int32)
    nl = np.asarray([7, 0, 6, 3, 2], np.int32)
    want = jattn._append_latent({k: jnp.asarray(v) for k, v in cache.items()},
                                jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(offs),
                                jnp.asarray(nl))
    got = {k: _t(v) for k, v in cache.items()}
    tattn._append_latent(got, _t(ckv), _t(kr), _t(offs), _t(nl))
    for name in ("ckv", "krope"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(got["ckv"][1].numpy(), cache["ckv"][1])
    np.testing.assert_array_equal(got["ckv"][2, 15].numpy(), ckv[2, 5])   # clamped


def test_mla_decode_bf16_matches_reference():
    """bfloat16 weights, activations and cache in both: the latent stays in
    its dtype through the products, summed in float32."""
    tspec, jspec, params, x, cache = _mla_case(24, seed=4)
    jp, _, tp, _, jcache, tcache = _both(params, x, cache, "bfloat16")
    xd = np.random.default_rng(5).normal(size=(3, 1, D_MODEL)).astype(np.float32)
    L = np.asarray([4, 11, 15], np.int32)
    jout, jcache = jattn.mla_decode(jp, jnp.asarray(xd).astype(jnp.bfloat16), jcache,
                                    jnp.asarray(L), jspec)
    tout = tattn.mla_decode(tp, _t(xd).bfloat16(), tcache, _t(L), tspec)
    assert tout.dtype == torch.bfloat16 and tcache["ckv"].dtype == torch.bfloat16
    _close(tout, np.asarray(jout.astype(jnp.float32)), **BF16_TOL)
    _cache_equalish(tcache, {k: np.asarray(v.astype(jnp.float32)) for k, v in jcache.items()},
                    **BF16_TOL)


@pytest.mark.parametrize("dtype,dims,want", [
    (torch.bfloat16, (192, 128), (192, 128)),     # deepseek-v2: native, no padding
    (torch.bfloat16, (24, 16), (32, 32)),         # deepseek-v2-smoke: padded
    (torch.float32, (24, 16), (32, 32)),
    (torch.bfloat16, (160, 128), (192, 128)),
    (torch.bfloat16, (128, 128), (128, 128)),
    (torch.float32, (192, 128), None),            # no f32 kernel at 192
    (torch.bfloat16, (192, 192), None),           # nothing that wide
])
def test_attention_kernel_head_dims(dtype, dims, want):
    """The (q/k, v) head dims ``ops.attention`` runs the card's kernels at:
    the pair itself when they take it, else the next pair they take, else
    it raises (no fallback to the plain version)."""
    from repro_torch.kernels.flash_attention import fa_head_dims

    if want is None:
        with pytest.raises(ValueError, match="head dims"):
            fa_head_dims(dtype, *dims)
    else:
        assert fa_head_dims(dtype, *dims) == want


# ---------------------------------------------------------------------------
# deepseek-v2-smoke through the bundle
# ---------------------------------------------------------------------------

def _bundles(no_drop=False):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(smoke_config(ARCH), dtype="float32")
    if no_drop:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=float(jcfg.moe.n_experts)))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=float(tcfg.moe.n_experts)))
    return JaxBundle(jcfg), ModelBundle(tcfg)


@pytest.fixture(scope="module")
def deepseek():
    jb, tb = _bundles()
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _caches_close(tcache, jcache):
    """Each leaf at rtol 1e-4 and atol 1e-4 of its scale (the f32 limit
    taken on the leaf's scale).  The smoke weights are drawn at
    1/sqrt(stack count) = 1 (every stage of deepseek-v2-smoke holds one
    layer), so latents reach ~30 and MLA scores ~1e3: a near one-hot
    softmax passes the scores' f32 rounding (~1e-4 absolute) on to the next
    layer's latents at ~5e-5 of their scale after a few decode steps."""
    jl, tl = jax.tree.leaves(jcache), tree_leaves(tcache)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j, rtol=1e-4, atol=max(1e-4, 1e-4 * float(np.abs(j).max())))


def test_deepseek_smoke_lays_out_a_lead_stage(deepseek):
    jb, _, tb, tparams = deepseek
    assert tb.cfg.stages() == [("F", 1, 0), ("F", 1, 1)]
    lead, rest = tparams["stages"]
    assert "mlp" in lead["0F"] and "moe" in rest["0F"]
    assert lead["0F"]["mlp"]["w_up"].shape == (1, 64, 128)
    assert rest["0F"]["attn"]["w_q_b"].shape == (1, 32, 4, 24)
    assert tb.cache_bytes_for(3, 40) == jb.cache_bytes_for(3, 40) == 2 * 3 * 40 * 40 * 2


def test_deepseek_prefill_then_decode_match_reference(deepseek):
    """Whole-prompt prefill of 20 tokens (through ``ops.attention`` at q/k
    head dim 24, v 16), then 8 greedy decode steps; logits, tokens and the
    latent caches."""
    jb, jparams, tb, tparams = deepseek
    toks = np.random.default_rng(3).integers(0, jb.cfg.vocab, (2, 20)).astype(np.int32)
    jpre = jax.jit(lambda p, b, c: jb.prefill(p, b, c))
    jdec = jax.jit(lambda p, b, c: jb.decode_step(p, b, c))
    jlog, jcache = jpre(jparams, {"tokens": jnp.asarray(toks)},
                        jb.init_cache(2, 32, "float32"))
    tcache = tb.init_cache(2, 32, dtype="float32", device="cpu")
    tlog, _ = tb.prefill(tparams, {"tokens": _t(toks)}, tcache)
    _close(tlog, jlog)
    _caches_close(tcache, jcache)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for step in range(8):
        lengths = np.full(2, 20 + step, np.int32)
        jlog, jcache = jdec(jparams, {"tokens": jnp.asarray(tok),
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


@pytest.fixture(scope="module")
def deepseek_scaled(deepseek):
    """deepseek-v2-smoke's weights with each attention projection scaled by
    1/sqrt(its fan-in), the same numbers in both packages.  Under the smoke
    init (every stage holds one layer, so its weights are N(0, 1)) the MLA
    scores reach ~1e4: the softmax is one-hot, and the gradients that pass
    through it (dS = P (dP - delta)) are rounding residues that differ
    between the packages by ~1e-2 of their scale, though the forwards
    agree to 1e-6.  Scaled, the scores are O(10) and the gradients are
    computed, not residues."""
    jb, jparams, tb, _ = deepseek
    tree = jax.tree.map(np.asarray, jparams)
    for stage in tree["stages"]:
        att = stage["0F"]["attn"]
        for name, w in att.items():
            fan_in = int(np.prod(w.shape[1:3])) if name == "w_o" else w.shape[1]
            att[name] = (w / np.sqrt(fan_in)).astype(np.float32)
    return (jb, jax.tree.map(jnp.asarray, tree), tb,
            convert.params_from_jax(tree, "cpu"))


def test_deepseek_prefill_at_then_decode_match_reference(deepseek_scaled):
    """Chunks of 8 over 3 rows at their own offsets (prompts of 30, 17 and
    5 tokens: rows go idle and are routed all the same), then greedy
    decode steps to 40 positions; logits of the rows that wrote, tokens
    and caches.  On ``deepseek_scaled``'s weights: under the smoke init
    the one-hot softmax passes the scores' rounding on, and over 40
    positions a logit drifts to ~1.5e-4 in each package."""
    jb, jparams, tb, tparams = deepseek_scaled
    B, chunk = 3, 8
    jcache, tcache = jb.init_cache(B, 48, "float32"), tb.init_cache(B, 48, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jb.cfg.vocab, n).astype(np.int32) for n in (30, 17, 5)]
    jpf = jax.jit(lambda p, b, c, o: jb.prefill_at(p, b, c, o))
    jdec = jax.jit(lambda p, b, c: jb.decode_step(p, b, c))
    offs = np.zeros(B, np.int32)
    lens = [len(p) - 1 for p in prompts]
    for lo in range(0, max(lens), chunk):
        toks, nl = np.zeros((B, chunk), np.int32), np.zeros(B, np.int32)
        for i, pr in enumerate(prompts):
            n = int(np.clip(lens[i] - lo, 0, chunk))
            toks[i, :n], nl[i] = pr[lo:lo + n], n
        jlog, jcache = jpf(jparams, {"tokens": jnp.asarray(toks), "new_lens": jnp.asarray(nl)},
                           jcache, jnp.asarray(offs))
        tlog, _ = tb.prefill_at(tparams, {"tokens": _t(toks), "new_lens": _t(nl)}, tcache,
                                _t(offs))
        live = nl > 0
        _close(tlog[torch.from_numpy(live)], np.asarray(jlog)[live])
        offs += nl
    _caches_close(tcache, jcache)
    tok = np.asarray([[p[-1]] for p in prompts], np.int32)
    for step in range(40 - int(offs.max())):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jnp.asarray(tok),
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


@pytest.fixture(scope="module")
def deepseek_loss(deepseek_scaled):
    """A batch of 2 x 16 tokens and the reference's loss, metrics and
    gradients on ``deepseek_scaled``'s weights, once: every remat mode
    computes the same function, so each of the port's is held to them."""
    jb, jparams, _, _ = deepseek_scaled
    toks = np.random.default_rng(4).integers(0, jb.cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jb.train_loss(p, jbatch, remat="none"), has_aux=True))(jparams)
    return batch, want, jm, jgrads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_deepseek_loss_aux_and_grads_match_reference(deepseek_scaled, deepseek_loss, remat):
    """Loss (ce + 0.01 aux), ce and aux, and every gradient (both stages,
    the MLA weights included), under each remat mode of the port, on
    ``deepseek_scaled``'s weights."""
    _, _, tb, tparams = deepseek_scaled
    batch, want, jm, jgrads = deepseek_loss
    live = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    leaves = tree_leaves(live)
    got, tm = tb.train_loss(live, {k: _t(v) for k, v in batch.items()}, remat=remat)
    it = iter(torch.autograd.grad(got, leaves))
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(tm["ce"], jm["ce"], atol=1e-5, rtol=1e-5)
    _close(tm["aux"], jm["aux"], atol=1e-5, rtol=1e-5)
    assert float(tm["aux"].detach()) > 0.5        # one MoE layer, ~1 (E · Σ me · ce)
    tree_map(lambda g, w: _close(g, w, rtol=1e-4,
                                 atol=2e-4 * max(float(np.abs(w).max()), 1e-6)),
             tree_map(lambda _: next(it), live), jgrads)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab, lens=(20, 9, 25, 4, 14), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


NEW = 8


def _port_tokens(tb, tparams, prompts, slots=2, arrivals=False, **kw):
    server = Server(tb, ServeConfig(batch_slots=slots, max_len=48, prefill_chunk=4, **kw),
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


def _jax_tokens(jb, jparams, prompts, slots=2):
    server = JaxServer(jb, JaxServeConfig(batch_slots=slots, max_len=48, prefill_chunk=4),
                       jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=1000)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def deepseek_tokens(deepseek):
    """The reference ``Server``'s greedy tokens (2 slots, chunk 4, max_len
    48)."""
    jb, jparams, _, _ = deepseek
    return _jax_tokens(jb, jparams, _prompts(jb.cfg.vocab))


@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "weights_stream", "kv=host"])
def test_deepseek_server_tokens_match_reference(deepseek, deepseek_tokens, policy):
    """The latent cache through each placement: resident, streamed to and
    from host memory a layer at a time (``kv_host``: an MLA entry goes back
    whole, one copy a leaf), weights streamed, and RESIDENT in host
    memory."""
    _, _, tb, tparams = deepseek
    server, got = _port_tokens(tb, tparams, _prompts(tb.cfg.vocab), policy=policy)
    assert server.policy.name == parse_policy(policy).name
    assert got == deepseek_tokens


def test_deepseek_preempted_tokens_match_reference():
    """Arrivals one every 2 ticks into 2 slots with preemption, under a
    capacity that holds every token: the reference ``Server``'s tokens,
    with latent slots spilled and promoted."""
    jb, tb = _bundles(no_drop=True)
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = _prompts(tb.cfg.vocab)
    want = _jax_tokens(jb, jparams, prompts)
    server, got = _port_tokens(tb, tparams, prompts, arrivals=True, preempt=True,
                               preempt_wait=2, verify_spills=True)
    st = server.stats()
    assert got == want
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    assert st["spill_corruptions"] == 0


@pytest.mark.parametrize("launcher,args,said", [
    ("serve", ["--requests", "3", "--slots", "2", "--max-len", "48",
               "--prefill-chunk", "4"], "served 3 requests"),
    ("train", ["--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
               "--ckpt-every", "100"], "done: 2 steps"),
])
def test_launchers_deepseek_cpu_smoke(launcher, args, said, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    extra = ["--ckpt-dir", str(tmp_path)] if launcher == "train" else []
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", ARCH, "--smoke",
         "--device", "cpu", *args, *extra],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert said in res.stdout + res.stderr, res.stdout + res.stderr
