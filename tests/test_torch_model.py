"""The port's model modules vs the JAX reference, one by one and whole.

Weights come from the reference's ``init_params`` and are carried across
with ``repro_torch.convert``; inputs are numpy arrays from a seed fed to
both.  Everything runs in float32 on the CPU (the port's plain attention
path) with atol/rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.configs import smoke_config as jax_smoke_config
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), **(kw or TOL)
    )


# ---------------------------------------------------------------------------
# layers, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    params = {"scale": rng.normal(size=64).astype(np.float32),
              "bias": rng.normal(size=64).astype(np.float32)}
    p = {k: params[k] for k in tlayers.norm_defs(64, kind)}
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 6, 128)).astype(np.float32)
    pos = rng.integers(0, 2048, size=(2, 1, 6)).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope(_t(x), _t(pos), theta)
    _close(got, want, atol=1e-4, rtol=1e-4)


def test_apply_mlp_and_head():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    mlp = {n: rng.normal(size=s).astype(np.float32) * 0.2 for n, s in
           (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                             jnp.asarray(x))
    got = tlayers.apply_mlp({k: _t(v) for k, v in mlp.items()}, _t(x))
    _close(got, want, atol=1e-5, rtol=1e-5)
    emb = {"embedding": rng.normal(size=(100, 32)).astype(np.float32)}
    unembed = {"unembed": rng.normal(size=(32, 100)).astype(np.float32)}
    for head in ({}, unembed):
        want = jlayers.apply_head({k: jnp.asarray(v) for k, v in head.items()},
                                  {"embedding": jnp.asarray(emb["embedding"])},
                                  jnp.asarray(x))
        got = tlayers.apply_head({k: _t(v) for k, v in head.items()},
                                 {"embedding": _t(emb["embedding"])}, _t(x))
        assert got.dtype == torch.float32
        _close(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_head_emits_f32_logits():
    emb = torch.randn(50, 16).to(torch.bfloat16)
    x = torch.randn(2, 1, 16).to(torch.bfloat16)
    logits = tlayers.apply_head({}, {"embedding": emb}, x)
    assert logits.dtype == torch.float32 and logits.shape == (2, 1, 50)
    torch.testing.assert_close(logits, x.float() @ emb.float().T)


@pytest.mark.parametrize("size", [16, 5])
def test_ring_positions(size):
    offs = np.asarray([0, 3, 16, 23], np.int32)
    want = jattn._ring_positions(jnp.asarray(offs), size)
    got = tattn._ring_positions(_t(offs), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "size,S,offsets,new_lens",
    [
        (16, 4, [0, 5, 12, 3], [4, 2, 4, 0]),     # plain append, a no-op row
        (8, 12, [0, 3, 6, 1], [12, 9, 5, 0]),     # the chunk outruns the ring
        (6, 4, [4, 5, 0, 2], [4, 3, 1, 4]),       # wraps around the ring
    ],
)
def test_append_kv(size, S, offsets, new_lens):
    rng = np.random.default_rng(size + S)
    B, H, D = 4, 2, 8
    cache = {n: rng.normal(size=(B, H, size, D)).astype(np.float32)
             for n in ("k", "v")}
    k_new = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v_new = rng.normal(size=(B, H, S, D)).astype(np.float32)
    offs, nl = np.asarray(offsets, np.int32), np.asarray(new_lens, np.int32)
    want = jattn._append_kv({n: jnp.asarray(c) for n, c in cache.items()},
                            jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(offs), jnp.asarray(nl))
    got = {n: _t(c.copy()) for n, c in cache.items()}
    tattn._append_kv(got, _t(k_new), _t(v_new), _t(offs), _t(nl))
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    # a row with new_lens == 0 keeps its cache bit for bit
    for b in np.flatnonzero(nl == 0):
        np.testing.assert_array_equal(got["k"][b].numpy(), cache["k"][b])


# ---------------------------------------------------------------------------
# the slice: prefill_at chunks then decode steps
# ---------------------------------------------------------------------------

def _bundles(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    return JaxBundle(jcfg), ModelBundle(tcfg)


@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b", "granite-8b"])
def test_prefill_then_decode_matches_reference(arch):
    jb, tb = _bundles(arch)
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    # carrying across is a tree map over the same structure
    assert len(tree_leaves(tparams)) == len(jax.tree.leaves(jparams))

    B, max_len, chunk = 3, 32, 4
    jcache = jb.init_cache(B, max_len)
    tcache = tb.init_cache(B, max_len, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jb.cfg.vocab, n).astype(np.int32)
               for n in (8, 6, 1)]
    jpf = jax.jit(lambda p, b, c, o: jb.prefill_at(p, b, c, o))
    jdec = jax.jit(lambda p, b, c: jb.decode_step(p, b, c))

    offs = np.zeros(B, np.int32)
    lens = [len(p) - 1 for p in prompts]
    for lo in range(0, max(lens), chunk):                  # two chunks
        toks = np.zeros((B, chunk), np.int32)
        nl = np.zeros(B, np.int32)
        for i, pr in enumerate(prompts):
            n = int(np.clip(lens[i] - lo, 0, chunk))
            toks[i, :n] = pr[lo:lo + n]
            nl[i] = n
        jlog, jcache = jpf(jparams, {"tokens": jnp.asarray(toks),
                                     "new_lens": jnp.asarray(nl)},
                           jcache, jnp.asarray(offs))
        tlog, tcache = tb.prefill_at(tparams, {"tokens": _t(toks),
                                               "new_lens": _t(nl)},
                                     tcache, _t(offs.copy()))
        live = nl > 0                                      # garbage otherwise
        _close(tlog[torch.from_numpy(live)], np.asarray(jlog)[live])
        offs += nl
    assert (offs == [7, 5, 0]).all()

    tok = np.asarray([[p[-1]] for p in prompts], np.int32)
    jtok, ttok = jnp.asarray(tok), _t(tok)
    for step in range(4):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jtok,
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, tcache = tb.decode_step(tparams, {"tokens": ttok,
                                                "lengths": _t(lengths)}, tcache)
        _close(tlog, jlog)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

    jleaves = jax.tree.leaves(jcache)
    tleaves = tree_leaves(tcache)
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        _close(tl, jl)


def test_bundle_rejects_unported_families():
    for arch in ("internvl2-1b", "deepseek-v2-236b", "gemma3-27b",
                 "seamless-m4t-medium", "llama4-maverick-400b-a17b"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
            ModelBundle(smoke_config(arch))


def test_own_init_follows_reference_rule():
    """The port's own init: ones/zeros where the reference has them, the
    embedding at 0.02, stacked weights at 1/sqrt(stack count)."""
    tb = ModelBundle(smoke_config("yi-6b"))
    params = tb.init_params(torch.Generator().manual_seed(0), "float32")
    stage = params["stages"][0]["0F"]
    assert torch.equal(stage["attn_norm"]["scale"],
                       torch.ones_like(stage["attn_norm"]["scale"]))
    assert abs(float(params["embed"]["embedding"].std()) - 0.02) < 2e-3
    n = tb.cfg.n_layers
    assert abs(float(stage["mlp"]["w_up"].std()) - n ** -0.5) < 0.05
    again = tb.init_params(torch.Generator().manual_seed(0), "float32")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(again)))
    assert tree_map(lambda t: t.dtype, params)["embed"]["embedding"] == torch.float32
