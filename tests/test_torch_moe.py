"""The GShard MoE FFN and llama4-maverick-smoke vs the JAX reference.

* ``capacity`` and ``moe_defs`` against the reference's (equal);
* ``apply_moe``'s output and aux loss on shared numpy inputs, top-1 and
  top-2, 4 and 8 experts, with and without the shared expert, each
  activation, several groups and ``capacity_factor=0.25`` (which drops
  tokens): float32 at atol/rtol 1e-5; bfloat16 at 5e-2 (the kernels'
  bf16 limit, ``tests/test_torch_kernels.py``) on inputs whose router
  products are exact in bf16, so both packages route the same tokens;
  gradients of out and aux against ``jax.grad`` at 1e-4;
* tied router logits (duplicated router columns, exact dyadic inputs)
  routed as ``jax.lax.top_k`` routes them: the lower expert index first;
* llama4-maverick-smoke (``CCCG``, chunk 64, MoE on layers 1 and 3, 4
  experts top-1 + 1 shared) in float32 through ``ModelBundle``: prefill,
  ``prefill_at`` and decode logits and caches within the first chunk at
  1e-4 (``tests/test_torch_model.py``), the loss, ce, aux and grads under
  remat ``none``/``full``/``dots`` (grads as ``tests/test_torch_train.py``
  holds them), and the reference ``Server``'s greedy tokens at 2 and 4
  slots under four placements and with preemption;
* past the chunk, greedy tokens against the port's own full-sequence
  forward (the reference's ``C`` decode masks by slot there, ROADMAP C1).

Routing couples the rows of a step: through the capacity a token's
output depends on the tokens routed before it in its group.  The served
tokens match the reference's because both route the same rows (idle
slots and chunk padding included) in the same order.  Where the schedule
may differ (preemption, whose decisions read wall time) or the grouping
does (a full-sequence forward against serving steps), the test uses a
variant whose capacity holds every token (``capacity_factor = n_experts``,
so C >= G·K and nothing drops): there a token's output is its own.
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

from repro.configs import MoESpec as JaxMoESpec
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import MoESpec, get_config, smoke_config
from repro_torch.core.placement import parse_policy
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding
from repro_torch.models import transformer as ttf
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import Param, tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "llama4-maverick-400b-a17b"
TOL = dict(atol=1e-4, rtol=1e-4)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
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
# capacity and defs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,E,K,cf", [
    (8, 4, 1, 1.25), (2, 4, 1, 1.25), (32, 4, 1, 0.25), (2048, 128, 1, 1.25),
    (2048, 160, 6, 1.25), (8, 128, 1, 1.25), (100, 8, 2, 1.0), (64, 4, 2, 4.0),
])
def test_capacity_matches_reference(group, E, K, cf):
    kw = dict(n_experts=E, top_k=K, d_ff_expert=8, capacity_factor=cf)
    got = tmoe.capacity(group, MoESpec(**kw))
    assert got == jmoe.capacity(group, JaxMoESpec(**kw))
    assert got % 4 == 0 and got >= max(K, 4)


@pytest.mark.parametrize("E,n_shared", [(4, 0), (4, 1), (8, 2)])
def test_moe_defs_match_reference(E, n_shared):
    kw = dict(n_experts=E, top_k=1, d_ff_expert=24, n_shared=n_shared)
    got = tmoe.moe_defs(16, MoESpec(**kw))
    want = jmoe.moe_defs(16, JaxMoESpec(**kw))
    fields = lambda p: (tuple(p.shape), tuple(p.axes), p.init, p.scale, p.dtype)  # noqa: E731
    assert tree_map(fields, got) == jax.tree.map(
        fields, want, is_leaf=lambda p: hasattr(p, "axes"))
    assert ("shared" in got) == bool(n_shared)
    assert tmoe.DEFAULT_GROUP == jmoe.DEFAULT_GROUP == 2048


# ---------------------------------------------------------------------------
# apply_moe against the reference's
# ---------------------------------------------------------------------------

D = 32


def _case(E, K, n_shared, cf=1.25, seed=0, dyadic=False, B=2, S=16):
    """Specs of both packages, params and x (numpy f32).  ``dyadic``: x and
    the router take values on a grid of 1/2 and 1/4, so every router
    product is exact in float32 and bfloat16 whatever the summation order
    (the routing is then the same in both packages, ties included)."""
    kw = dict(n_experts=E, top_k=K, d_ff_expert=24, n_shared=n_shared, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    params = tree_map(lambda p: (rng.normal(size=p.shape) * 0.3).astype(np.float32),
                      tmoe.moe_defs(D, MoESpec(**kw)))
    if dyadic:
        params["router"] = rng.integers(-1, 2, (D, E)).astype(np.float32) / 4
        x = rng.integers(-2, 3, (B, S, D)).astype(np.float32) / 2
    else:
        x = rng.normal(size=(B, S, D)).astype(np.float32)
    return MoESpec(**kw), JaxMoESpec(**kw), params, x


def _run(params, x, tspec, jspec, act="silu", group=jmoe.DEFAULT_GROUP, dtype="float32"):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    tp = tree_map(lambda a: _t(a).to(tdt), params)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x).astype(jdt), jspec, act, group)
    tout, taux = tmoe.apply_moe(tp, _t(x).to(tdt), tspec, act, group)
    assert tout.dtype == tdt and taux.dtype == torch.float32
    return (tout, taux), (np.asarray(jout.astype(jnp.float32)), float(jaux))


def _routed(x, params, spec, group):
    """(kept, sent) (token, choice) pairs of the reference's routing: how
    many survive the capacity out of how many were routed."""
    E, K = spec.n_experts, spec.top_k
    xg = jnp.asarray(x).reshape(-1, min(group, x.shape[0] * x.shape[1]), x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg, params["router"]), -1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E)
    g, G = xg.shape[:2]
    pos = jnp.cumsum(onehot.reshape(g, G * K, E), 1).reshape(g, G, K, E) * onehot - 1
    C = jmoe.capacity(G, spec)
    return int(((pos >= 0) & (pos < C)).sum()), g * G * K


MOE_CASES = [
    # (E, K, n_shared, act, group, capacity_factor)
    (4, 1, 0, "silu", 2048, 1.25),
    (4, 1, 1, "silu", 2048, 1.25),
    (8, 1, 1, "gelu", 2048, 1.25),
    (8, 2, 0, "relu", 2048, 1.25),
    (4, 2, 1, "silu", 8, 1.25),          # 4 groups
    (8, 1, 0, "silu", 16, 1.25),         # 2 groups
    (4, 1, 1, "silu", 2048, 0.25),       # drops
    (4, 2, 1, "gelu", 16, 0.25),         # drops in 2 groups
]


@pytest.mark.parametrize("E,K,n_shared,act,group,cf", MOE_CASES)
def test_apply_moe_matches_reference(E, K, n_shared, act, group, cf):
    tspec, jspec, params, x = _case(E, K, n_shared, cf)
    (tout, taux), (jout, jaux) = _run(params, x, tspec, jspec, act, group)
    _close(tout, jout, **MOE_TOL)
    assert abs(float(taux) - jaux) <= 1e-6 * max(abs(jaux), 1.0)
    if cf < 1:                              # the drop cases do drop
        kept, sent = _routed(x, params, jspec, group)
        assert kept < sent


@pytest.mark.parametrize("E,K,n_shared,act,group,cf", [
    (4, 1, 1, "silu", 2048, 1.25), (8, 2, 0, "gelu", 8, 1.25), (4, 1, 0, "relu", 2048, 0.25),
])
def test_apply_moe_bf16_matches_reference(E, K, n_shared, act, group, cf):
    """bf16 in both, the router's products exact: the same tokens routed
    and dropped; the expert products round within bf16's limit.  The
    combine weights are cast to bf16 before the output product in both."""
    tspec, jspec, params, x = _case(E, K, n_shared, cf, seed=1, dyadic=True)
    (tout, taux), (jout, jaux) = _run(params, x, tspec, jspec, act, group, "bfloat16")
    _close(tout, jout, **BF16_TOL)
    assert abs(float(taux) - jaux) <= 1e-5 * max(abs(jaux), 1.0)


@pytest.mark.parametrize("E,K,n_shared,group,cf", [
    (4, 1, 1, 2048, 1.25), (8, 2, 0, 8, 1.25), (4, 2, 1, 2048, 0.25)])
def test_apply_moe_grads_match_reference(E, K, n_shared, group, cf):
    """d/d(params, x) of sum(out · ct) + 0.3 aux against ``jax.grad``, each
    leaf at 1e-4 of its scale.  Under top-1 the renormalised gate is p / p
    = 1, whose gradient is 0 in exact arithmetic and a rounding residue
    in each package (~1 % of the router's gradient here, which otherwise
    comes from the aux loss): the router's leaf is held at 1e-2 of its
    scale there."""
    tspec, jspec, params, x = _case(E, K, n_shared, cf, seed=2)
    ct = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, xx, jspec, "silu", group)
        return jnp.sum(out * ct) + 0.3 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                              jnp.asarray(x))
    tp = tree_map(lambda a: _t(a).requires_grad_(), params)
    tx = _t(x).requires_grad_()
    out, aux = tmoe.apply_moe(tp, tx, tspec, "silu", group)
    grads = torch.autograd.grad(torch.sum(out * _t(ct)) + 0.3 * aux,
                                tree_leaves(tp) + [tx])
    it = iter(grads)
    got = tree_map(lambda _: next(it), tp)
    want = jax.tree.map(np.asarray, jgp)
    for name in got:
        rel = 1e-2 if (name == "router" and K == 1) else 1e-4
        tree_map(lambda g, w: _close(g, w, rtol=1e-4,
                                     atol=rel * max(float(np.abs(w).max()), 1e-6)),
                 got[name], want[name])
    _close(next(it), jgx, rtol=1e-4, atol=1e-4 * float(np.abs(jgx).max()))


# ---------------------------------------------------------------------------
# ties: the lower expert index first, as jax.lax.top_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_toward_the_lower_index(k):
    rows = np.asarray([[1, 3, 3, 0, 3], [2, 2, 2, 2, 2], [0, 1, 0, 1, 1],
                       [5, 4, 5, 4, 3]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
    tv, ti = tmoe.top_k(_t(rows), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("K,dup", [(1, [(0, 2), (1, 3)]), (2, [(0, 1), (2, 3)]),
                                   (1, [(3, 0), (2, 1)])])
def test_tied_router_logits_route_as_reference(K, dup):
    """Router columns duplicated (column ``b`` a copy of ``a``): every
    token's logits tie between the pair, exactly, and the output equals
    the reference's, which routes to the lower index of each tie; a
    capacity of 4 over 32 tokens makes the tie decide which tokens drop."""
    E = 4
    tspec, jspec, params, x = _case(E, K, 1, cf=0.5, seed=4, dyadic=True, S=16)
    for a, b in dup:
        params["router"][:, b] = params["router"][:, a]
    (tout, taux), (jout, jaux) = _run(params, x, tspec, jspec)
    _close(tout, jout, **MOE_TOL)
    assert abs(float(taux) - jaux) <= 1e-6 * max(abs(jaux), 1.0)
    logits = x.reshape(-1, D) @ params["router"]
    top = logits.max(-1)
    for a, b in dup:
        assert (logits[:, a] == logits[:, b]).all()
    # the ties decide: many tokens' largest logit is a tied pair's
    assert sum(int((logits[:, a] == top).sum()) for a, _ in dup) >= 8


def test_apply_moe_asserts_the_group_divides_the_tokens():
    tspec, jspec, params, x = _case(4, 1, 0, S=12)
    with pytest.raises(AssertionError):
        tmoe.apply_moe(tree_map(_t, params), _t(x), tspec, "silu", 16)
    with pytest.raises(AssertionError):
        jmoe.apply_moe(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jspec, "silu", 16)


# ---------------------------------------------------------------------------
# llama4-maverick-smoke through the bundle
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
def llama():
    jb, tb = _bundles()
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


@pytest.fixture(scope="module")
def llama_no_drop(llama):
    """The same weights under a capacity that holds every token."""
    _, jparams, _, tparams = llama
    jb, tb = _bundles(no_drop=True)
    return jb, jparams, tb, tparams


def _caches_close(tcache, jcache):
    """Each cache leaf at rtol 1e-4 and atol 5e-5 of the leaf's scale (at
    least 1e-4).  The smoke config draws its stacked weights at 1/sqrt(stack
    count) = 1, so the residual stream past layer 0 reaches ~1e3, keys and
    values ~35, and attention scores ~1e3: softmax rounds to near one-hot
    and passes f32 rounding of the scores on at ~1e-5 of the cache's scale
    (layer 0's leaves agree to 2e-7 of theirs)."""
    jl, tl = jax.tree.leaves(jcache), tree_leaves(tcache)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j, rtol=1e-4, atol=max(1e-4, 5e-5 * float(np.abs(j).max())))


def test_llama4_bundle_builds_and_lays_out_its_moe_layers():
    """The full config builds (34.25 B params at depth 4, 399.7 B at 48);
    layers 1 and 3 of each CCCG period hold the MoE, 0 and 2 the dense
    FFN of ``dense_d_ff``; the defs equal the reference's."""
    tb = ModelBundle(get_config(ARCH))
    defs = tb.param_defs()["stages"][0]
    assert tb.cfg.stages() == [("CCCG", 12, 0)]
    assert [("moe" in defs[k], "mlp" in defs[k]) for k in ("0C", "1C", "2C", "3G")] == [
        (False, True), (True, False), (False, True), (True, False)]
    assert defs["1C"]["moe"]["w_gate"].shape == (12, 128, 5120, 8192)
    assert defs["0C"]["mlp"]["w_up"].shape == (12, 5120, 16384)
    assert defs["1C"]["moe"]["shared"]["w_down"].shape == (12, 8192, 5120)
    assert round(tb.cfg.num_params() / 1e9, 2) == 399.68
    four = ModelBundle(dataclasses.replace(get_config(ARCH), n_layers=4))
    assert round(four.cfg.num_params() / 1e9, 2) == 34.25
    n = sum(int(np.prod(p.shape)) for p in tree_leaves(four.param_defs()))
    assert n - 5 * 5120 * 2 + 5120 == four.cfg.num_params()     # the count skips norms
    jdefs = JaxBundle(jax_get_config(ARCH)).param_defs()
    shapes = lambda p: tuple(p.shape)  # noqa: E731
    assert tree_map(shapes, tb.param_defs()) == jax.tree.map(
        shapes, jdefs, is_leaf=lambda p: hasattr(p, "axes"))
    # a slot of 2048 positions: 4 C rings of 2048 (2 x chunk 8192 clipped) and a G cache
    assert four.cache_bytes_for(1, 2048) == 4 * 2048 * 2 * 8 * 128 * 2 == 33_554_432


def test_moe_period_must_divide_the_pattern():
    cfg = smoke_config(ARCH)
    bad = dataclasses.replace(cfg, layer_pattern="CCG", n_layers=3)
    with pytest.raises(AssertionError, match="moe_period"):
        ttf.lm_defs(bad)


def test_deepseek_v2_still_refused_for_mla():
    """No longer refused: MLA is ported (ROADMAP A4b), so the full
    deepseek-v2 builds, its dense lead layer a stage of its own (d_ff
    12288) before the 59 MoE layers (160 experts top-6 + 2 shared), its
    defs the reference's."""
    tb = ModelBundle(get_config("deepseek-v2-236b"))
    assert tb.cfg.stages() == [("F", 1, 0), ("F", 59, 1)]
    lead, moe = tb.param_defs()["stages"]
    assert "mlp" in lead["0F"] and "moe" not in lead["0F"]
    assert lead["0F"]["mlp"]["w_up"].shape == (1, 5120, 12288)
    assert moe["0F"]["moe"]["w_gate"].shape == (59, 160, 5120, 1536)
    assert moe["0F"]["attn"]["w_k_b"].shape == (59, 512, 128, 128)
    shapes = lambda p: tuple(p.shape)  # noqa: E731
    assert tree_map(shapes, tb.param_defs()) == jax.tree.map(
        shapes, JaxBundle(jax_get_config("deepseek-v2-236b")).param_defs(),
        is_leaf=lambda p: hasattr(p, "axes"))


def test_llama4_prefill_then_decode_match_reference(llama):
    """Whole-prompt prefill of 40 tokens, then 10 decode steps (to 50 < the
    chunk of 64); logits, greedy tokens and caches."""
    jb, jparams, tb, tparams = llama
    toks = np.random.default_rng(3).integers(0, jb.cfg.vocab, (2, 40)).astype(np.int32)
    jlog, jcache = jb.prefill(jparams, {"tokens": jnp.asarray(toks)},
                              jb.init_cache(2, 64, "float32"))
    tcache = tb.init_cache(2, 64, dtype="float32", device="cpu")
    tlog, _ = tb.prefill(tparams, {"tokens": _t(toks)}, tcache)
    _close(tlog, jlog)
    _caches_close(tcache, jcache)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for step in range(10):
        lengths = np.full(2, 40 + step, np.int32)
        jlog, jcache = jb.decode_step(jparams, {"tokens": jnp.asarray(tok),
                                                "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


def test_llama4_prefill_at_then_decode_match_reference(llama):
    """Chunks of 8 over 3 rows at their own offsets (prompts of 30, 17 and
    5 tokens: rows go idle, padded with zeros, and are routed all the
    same), then greedy decode steps to 50 positions; logits of the rows
    that wrote, tokens and caches."""
    jb, jparams, tb, tparams = llama
    B, chunk = 3, 8
    jcache, tcache = jb.init_cache(B, 64, "float32"), tb.init_cache(B, 64, device="cpu")
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
    for step in range(50 - int(offs.max())):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jnp.asarray(tok),
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_llama4_loss_aux_and_grads_match_reference(llama, remat):
    """Loss (ce + 0.01 aux), ce and aux, and every gradient, under each
    remat mode; 2 x 32 tokens in one group of 64, so the capacity (20)
    drops tokens."""
    jb, jparams, tb, tparams = llama
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jb.cfg.vocab, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jgrads = jax.value_and_grad(
        lambda p: jb.train_loss(p, jbatch, remat=remat), has_aux=True)(jparams)
    live = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    leaves = tree_leaves(live)
    got, tm = tb.train_loss(live, {k: _t(v) for k, v in batch.items()}, remat=remat)
    it = iter(torch.autograd.grad(got, leaves))
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(tm["ce"], jm["ce"], atol=1e-5, rtol=1e-5)
    _close(tm["aux"], jm["aux"], atol=1e-5, rtol=1e-5)
    assert float(tm["aux"].detach()) > 1.0    # 2 MoE layers, each ~1 (E · Σ me · ce)
    tree_map(lambda g, w: _close(g, w, rtol=1e-4,
                                 atol=2e-4 * max(float(np.abs(w).max()), 1e-6)),
             tree_map(lambda _: next(it), live), jgrads)


def test_llama4_train_step_reports_aux(llama):
    """The train step's metrics carry the aux loss, as the reference's."""
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.optim import init_opt_state

    _, _, tb, tparams = llama
    params = tree_map(lambda t: t.clone(), tparams)
    step = make_train_step(tb, TrainConfig(remat="full"))
    toks = np.random.default_rng(5).integers(0, tb.cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": _t(toks), "labels": _t(np.roll(toks, -1, 1))}
    _, _, _, m = step(params, init_opt_state(params), None, batch)
    want, wm = tb.train_loss(tparams, batch)
    assert set(m) >= {"loss", "ce", "aux", "grad_norm"}
    assert float(m["aux"]) == float(wm["aux"]) and float(m["loss"]) == float(want)


def test_launch_train_llama4_cpu_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt-every", "100", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "done: 2 steps" in res.stderr and " aux " in res.stderr, res.stderr


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab, lens=(20, 9, 33, 4, 27, 14), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _port_tokens(tb, tparams, prompts, new, slots, max_len=64, arrivals=False, **kw):
    server = Server(tb, ServeConfig(batch_slots=slots, max_len=max_len, prefill_chunk=4,
                                    **kw), tparams, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    pending, tick = list(reqs), 0
    while pending or server.has_work():
        while pending and (not arrivals or tick >= 2 * (len(reqs) - len(pending))):
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        assert tick < 3000
    assert all(r.done and len(r.out_tokens) == new for r in reqs)
    return server, [r.out_tokens for r in reqs]


def _jax_tokens(jb, jparams, prompts, new, slots):
    server = JaxServer(jb, JaxServeConfig(batch_slots=slots, max_len=64, prefill_chunk=4),
                       jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=1000)
    return [r.out_tokens for r in reqs]


NEW = 12     # the longest prompt (33) + 12 new tokens stays inside the chunk of 64


@pytest.fixture(scope="module", params=[2, 4], ids=lambda s: f"{s}slots")
def llama_tokens(request, llama):
    """The reference ``Server``'s greedy tokens (chunk 4, max_len 64) at
    ``slots`` slots."""
    jb, jparams, _, _ = llama
    prompts = _prompts(jb.cfg.vocab)
    assert max(len(p) for p in prompts) + NEW <= jb.cfg.attention.chunk
    return request.param, _jax_tokens(jb, jparams, prompts, NEW, request.param)


@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "weights_stream", "kv=host"])
def test_llama4_server_tokens_match_reference(llama, llama_tokens, policy):
    """The port's ``Server`` routes the rows the reference's routes — every
    slot's row in a decode step, every slot's chunk (padding included) in
    a prefill dispatch — so its greedy tokens are the reference's, under
    each placement."""
    _, _, tb, tparams = llama
    slots, want = llama_tokens
    server, got = _port_tokens(tb, tparams, _prompts(tb.cfg.vocab), NEW, slots,
                               policy=policy)
    assert server.policy.name == parse_policy(policy).name
    assert got == want


def test_llama4_prefill_dispatch_drops_tokens(llama):
    """The served prefill dispatches above do drop tokens: 2 slots x chunk
    4 is a group of 8 with a capacity of 4 an expert, and a row that
    writes nothing rides along as 4 padding tokens."""
    jb, _, _, _ = llama
    assert jmoe.capacity(2 * 4, jb.cfg.moe) == 4
    assert jmoe.capacity(4 * 4, jb.cfg.moe) == 8


def test_llama4_preempted_tokens_match_reference(llama_no_drop):
    """Arrivals one every 2 ticks into 2 slots with preemption (whose
    decisions read wall time, so the schedule differs from the
    reference's): under a capacity that holds every token, the reference
    ``Server``'s tokens, with slots spilled and promoted."""
    jb, jparams, tb, tparams = llama_no_drop
    prompts = _prompts(tb.cfg.vocab)
    want = _jax_tokens(jb, jparams, prompts, NEW, 2)
    server, got = _port_tokens(tb, tparams, prompts, NEW, 2, arrivals=True, preempt=True,
                               preempt_wait=2, verify_spills=True)
    st = server.stats()
    assert got == want
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    assert st["spill_corruptions"] == 0


@pytest.mark.parametrize("slots", [2, 3])
def test_llama4_tokens_past_the_chunk_match_full_recompute(llama_no_drop, slots):
    """Past the chunk of 64 (and the ring of 128), each greedy token is the
    argmax of the port's own full-sequence forward over prompt + the
    tokens before it.  The full-sequence forward routes the sequence as
    one group, the server a step's rows, so the two are the same function
    only when nothing drops: hence the capacity that holds every token."""
    _, _, tb, tparams = llama_no_drop
    prompts = _prompts(tb.cfg.vocab, lens=(70, 45, 100), seed=8)
    _, got = _port_tokens(tb, tparams, prompts, 40, slots, max_len=160)
    with torch.no_grad():
        for p, out in zip(prompts, got):
            seq = list(p)
            for tok in out:
                logits, _ = ttf.lm_forward(tparams, _t(np.asarray([seq], np.int32)), tb.cfg)
                assert int(torch.argmax(logits[0, -1])) == tok
                seq.append(tok)
    assert max(len(p) + 40 for p in prompts) > 128


def test_launch_serve_llama4_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "4", "--slots", "2", "--max-len", "64",
         "--prefill-chunk", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "served 4 requests" in res.stdout + res.stderr, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# drawing a large leaf in slices
# ---------------------------------------------------------------------------

def test_large_leaf_is_drawn_in_slices(monkeypatch):
    """A leaf over ``DRAW_BYTES`` of float32 is drawn in row slices into its
    output: N(0, 1) x scale, cast; a leaf under it draws exactly as a
    whole ``randn`` (the rule for every leaf before slicing)."""
    p = Param((3, 8, 16), (None, None, None))
    small = sharding._init_one(p, torch.Generator().manual_seed(0), "float32")
    want = torch.randn(p.shape, generator=torch.Generator().manual_seed(0)) * 3 ** -0.5
    assert torch.equal(small, want)
    monkeypatch.setattr(sharding, "DRAW_BYTES", 4 * 16 * 5)      # 5 rows a slice
    big = sharding._init_one(p, torch.Generator().manual_seed(0), "bfloat16")
    assert big.dtype == torch.bfloat16 and big.shape == p.shape
    rows = torch.randn(24, 16, generator=torch.Generator().manual_seed(0)) * 3 ** -0.5
    # the first slice consumes the generator as a whole draw of 5 rows does
    torch.testing.assert_close(big.view(-1, 16)[:5].float(), rows[:5].bfloat16().float(),
                               atol=0, rtol=0)
    assert 0.3 < float(big.float().std()) * 3 ** 0.5 < 1.7
    assert torch.isfinite(big.float()).all()
