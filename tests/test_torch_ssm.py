"""The port's Mamba-2 path vs the JAX reference, on the CPU.

* the plain SSD functions (``ssd_scan`` with and without a state,
  ``ssd_decode_step``, ``ssd_scan_sequential``) against the reference's
  oracles and its Pallas kernel (interpret mode), at the tolerances of
  ``tests/test_kernels.py`` (f32 2e-4, bf16 5e-2);
* one Mamba-2 block's ``ssm_prefill_at`` / ``ssm_decode``, and the
  mamba2 / zamba2 smoke models (``prefill_at`` chunks then decode steps,
  and whole-prompt ``prefill``) in float32: logits at atol = rtol = 1e-4,
  caches at 1e-4 x each leaf's scale (random-init SSM states reach 1e2-1e3,
  where an absolute limit means nothing);
* greedy tokens per rid against the reference ``Server``, oversubscribed,
  and the reused-slot 1-token-prompt case;
* carrying caches across keeps the float32 pin of the SSM state.

Inputs are numpy arrays from a seed, fed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import materialize, tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

#: tests/test_kernels.py:96-98
SSD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
           "bfloat16": dict(atol=5e-2, rtol=5e-2)}
#: tests/test_torch_model.py
TOL = dict(atol=1e-4, rtol=1e-4)
SSM_ARCHS = ["mamba2-780m", "zamba2-1.2b"]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _scaled_close(got, want, msg=""):
    """Scale-aware: atol 1e-4 x the leaf's largest |value| (at least 1)."""
    w = _np(want)
    scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1.0)
    np.testing.assert_allclose(_np(got), w, atol=1e-4 * scale, rtol=1e-4,
                               err_msg=msg)


def _ssd_inputs(B, T, H, P, N, seed, state=False):
    """x, dt (softplus-scaled), A (negative), B, C and an initial state."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, T, H, P)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(B, T, H)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.normal(size=H) * 0.5)).astype(np.float32)
    Bm = (rng.normal(size=(B, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, T, N)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(B, H, P, N))).astype(np.float32) if state else None
    return x, dt, A, Bm, Cm, h0


# ---------------------------------------------------------------------------
# the plain SSD functions
# ---------------------------------------------------------------------------

SSD_SHAPES = [
    (1, 128, 2, 16, 8, 32), (2, 256, 4, 32, 16, 64), (1, 64, 1, 64, 32, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_matches_reference_oracle(B, T, H, P, N, chunk, with_state, dtype):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, T, H, P, N, seed=T + H, state=with_state)
    kw = dict(chunk=chunk, return_state=with_state)
    want = jref.ssd_scan(_j(x, dtype), _j(dt), _j(A), _j(Bm, dtype), _j(Cm, dtype),
                         init_state=None if h0 is None else _j(h0), **kw)
    got = ref.ssd_scan(_t(x, dtype), _t(dt), _t(A), _t(Bm, dtype), _t(Cm, dtype),
                       init_state=None if h0 is None else _t(h0), **kw)
    if with_state:
        (got, got_h), (want, want_h) = got, want
        assert got_h.dtype == torch.float32
        np.testing.assert_allclose(_np(got_h), _np(want_h), **SSD_TOL[dtype])
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, H, P)
    np.testing.assert_allclose(_np(got), _np(want), **SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_matches_pallas_kernel(B, T, H, P, N, chunk, dtype):
    """Stateless, as the reference runs its Pallas kernel (interpret mode)."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, T, H, P, N, seed=3)
    want = jops.ssd_scan(_j(x, dtype), _j(dt), _j(A), _j(Bm, dtype), _j(Cm, dtype),
                         chunk=chunk, backend="pallas")
    got = ref.ssd_scan(_t(x, dtype), _t(dt), _t(A), _t(Bm, dtype), _t(Cm, dtype),
                       chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **SSD_TOL[dtype])


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_sequential_and_decode_step_match_reference(with_state):
    B, T, H, P, N = 2, 40, 3, 16, 8
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, T, H, P, N, seed=5, state=with_state)
    init_j = None if h0 is None else _j(h0)
    init_t = None if h0 is None else _t(h0)
    want = jref.ssd_scan_sequential(_j(x), _j(dt), _j(A), _j(Bm), _j(Cm),
                                    init_state=init_j)
    got = ref.ssd_scan_sequential(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                                  init_state=init_t)
    np.testing.assert_allclose(_np(got), _np(want), **SSD_TOL["float32"])
    # the chunked form agrees with the literal recurrence (chunk 8 | 40)
    chunked = ref.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=8,
                           init_state=init_t)
    np.testing.assert_allclose(_np(chunked), _np(got), **SSD_TOL["float32"])
    state = np.zeros((B, H, P, N), np.float32) if h0 is None else h0
    wy, wh = jref.ssd_decode_step(_j(x[:, 0]), _j(dt[:, 0]), _j(A), _j(Bm[:, 0]),
                                  _j(Cm[:, 0]), _j(state))
    gy, gh = ops.ssd_decode_step(_t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(Bm[:, 0]),
                                 _t(Cm[:, 0]), _t(state))
    np.testing.assert_allclose(_np(gy), _np(wy), **SSD_TOL["float32"])
    np.testing.assert_allclose(_np(gh), _np(wh), **SSD_TOL["float32"])


def test_ssd_prefill_state_matches_decode_continuation():
    """State hand-off: scan T tokens, then decode-step one more == the
    literal recurrence over T+1 tokens (tests/test_kernels.py:107-125)."""
    B, T, H, P, N = 1, 64, 2, 16, 8
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, T + 1, H, P, N, seed=4)
    y_full = ref.ssd_scan_sequential(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm))
    _, state = ref.ssd_scan(_t(x[:, :T]), _t(dt[:, :T]), _t(A), _t(Bm[:, :T]),
                            _t(Cm[:, :T]), chunk=32, return_state=True)
    y_last, _ = ref.ssd_decode_step(_t(x[:, T]), _t(dt[:, T]), _t(A), _t(Bm[:, T]),
                                    _t(Cm[:, T]), state)
    np.testing.assert_allclose(_np(y_last), _np(y_full[:, T]), atol=2e-4, rtol=2e-4)
    # and against the reference's own hand-off
    _, jstate = jref.ssd_scan(_j(x[:, :T]), _j(dt[:, :T]), _j(A), _j(Bm[:, :T]),
                              _j(Cm[:, :T]), chunk=32, return_state=True)
    np.testing.assert_allclose(_np(state), _np(jstate), atol=2e-4, rtol=2e-4)


def test_ops_ssd_scan_on_cpu_writes_state_out_in_place():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, 48, 2, 16, 8, seed=6, state=True)
    args = (_t(x), _t(dt), _t(A), _t(Bm), _t(Cm))
    want_y, want_h = ref.ssd_scan(*args, chunk=16, init_state=_t(h0),
                                  return_state=True)
    buf = _t(h0)
    y, h = ops.ssd_scan(*args, chunk=16, init_state=buf, return_state=True,
                        state_out=buf)
    assert h is buf
    assert torch.equal(y, want_y) and torch.equal(buf, want_h)
    with pytest.raises(ValueError, match="return_state"):
        ops.ssd_scan(*args, chunk=16, state_out=buf)
    # on the CPU autograd differentiates the plain version
    xg = _t(x).requires_grad_()
    ops.ssd_scan(xg, *args[1:], chunk=16).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


def test_ssd_scan_zero_dt_rows_keep_their_state_bit_for_bit():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(3, 32, 2, 16, 8, seed=8, state=True)
    dt[1] = 0.0
    dt[2, 5:] = 0.0
    _, h = ref.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=32,
                        init_state=_t(h0), return_state=True)
    assert torch.equal(h[1], _t(h0[1]))
    # a row whose dt is 0 past 5 positions has the state of those 5
    _, h5 = ref.ssd_scan(_t(x[2:, :5]), _t(dt[2:, :5]), _t(A), _t(Bm[2:, :5]),
                         _t(Cm[2:, :5]), chunk=5, init_state=_t(h0[2:]),
                         return_state=True)
    np.testing.assert_allclose(_np(h[2]), _np(h5[0]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# one Mamba-2 block
# ---------------------------------------------------------------------------

def _block(arch="mamba2-780m"):
    cfg = jax_smoke_config(arch)
    d, spec = cfg.d_model, cfg.ssm
    defs = tssm.ssm_defs(d, spec)
    params = materialize(defs, torch.Generator().manual_seed(1), "float32")
    # nonzero a_log / dt_bias / conv_b so every term is exercised
    rng = np.random.default_rng(1)
    for k in ("a_log", "dt_bias", "conv_b"):
        params[k] = _t((rng.normal(size=params[k].shape) * 0.5).astype(np.float32))
    jparams = {k: _j(v.numpy()) for k, v in params.items()}
    return cfg, d, spec, params, jparams


def _block_cache(B, d, spec, seed):
    rng = np.random.default_rng(seed)
    shapes = {k: p.shape for k, p in tssm.ssm_cache_defs(B, d, spec).items()}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_ssm_prefill_at_and_decode_block_match_reference():
    cfg, d, spec, params, jparams = _block()
    B, S = 4, 6
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cache = _block_cache(B, d, spec, seed=3)
    offs = np.asarray([0, 5, 9, 0], np.int32)        # rows 0, 3 start fresh
    nl = np.asarray([6, 3, 0, 0], np.int32)          # row 2 idles mid-stream
    want_out, want_cache = jssm.ssm_prefill_at(
        jparams, _j(x), {k: _j(v) for k, v in cache.items()}, _j(offs), _j(nl), d, spec)
    tcache = {k: _t(v) for k, v in cache.items()}
    views = dict(tcache)
    out = tssm.ssm_prefill_at(params, _t(x), views, _t(offs), _t(nl), d, spec)
    live = nl > 0
    np.testing.assert_allclose(_np(out)[live], _np(want_out)[live], **TOL)
    for k in ("conv", "ssm"):
        assert views[k] is tcache[k]                 # written in place
        _scaled_close(tcache[k], want_cache[k], k)
    # row 2: new_lens == 0 at a nonzero offset keeps both states bit for bit
    for k in ("conv", "ssm"):
        assert np.array_equal(tcache[k][2].numpy(), cache[k][2])
    # row 3: new_lens == 0 at offset 0 is a fresh slot: zero state
    assert not tcache["ssm"][3].any() and not tcache["conv"][3].any()

    tok = rng.normal(size=(B, 1, d)).astype(np.float32)
    want_out, want_cache = jssm.ssm_decode(jparams, _j(tok), want_cache, d, spec)
    out = tssm.ssm_decode(params, _t(tok), tcache, d, spec)
    np.testing.assert_allclose(_np(out), _np(want_out), **TOL)
    for k in ("conv", "ssm"):
        _scaled_close(tcache[k], want_cache[k], k)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

def _bundles(arch):
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _cache_close(tcache, jcache, arch):
    # the same structure: compare leaf by path, not by order
    tree_map(lambda t, j: _scaled_close(t, j, arch), tcache,
             jax.tree.map(np.asarray, jcache))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_at_then_decode_matches_reference(arch):
    jb, jparams, tb, tparams = _bundles(arch)
    assert len(tree_leaves(tparams)) == len(jax.tree.leaves(jparams))
    B, max_len, chunk = 3, 32, 4
    jcache = jb.init_cache(B, max_len)
    tcache = tb.init_cache(B, max_len, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jb.cfg.vocab, n).astype(np.int32) for n in (8, 6, 1)]
    jpf = jax.jit(lambda p, b, c, o: jb.prefill_at(p, b, c, o))
    jdec = jax.jit(lambda p, b, c: jb.decode_step(p, b, c))

    offs = np.zeros(B, np.int32)
    lens = [len(p) - 1 for p in prompts]
    for lo in range(0, max(lens), chunk):                 # two chunks
        toks = np.zeros((B, chunk), np.int32)
        nl = np.zeros(B, np.int32)
        for i, pr in enumerate(prompts):
            n = int(np.clip(lens[i] - lo, 0, chunk))
            toks[i, :n] = pr[lo:lo + n]
            nl[i] = n
        before = [t.clone() for t in tree_leaves(tcache)]
        jlog, jcache = jpf(jparams, {"tokens": _j(toks), "new_lens": _j(nl)},
                           jcache, _j(offs))
        tlog, tcache = tb.prefill_at(tparams, {"tokens": _t(toks), "new_lens": _t(nl)},
                                     tcache, _t(offs))
        live = nl > 0
        np.testing.assert_allclose(_np(tlog)[live], np.asarray(jlog)[live], **TOL)
        # an idle row mid-stream (offset > 0, new_lens == 0) keeps its
        # (conv, ssm) state and its KV bit for bit
        idle = np.flatnonzero((nl == 0) & (offs > 0))
        for old, new in zip(before, tree_leaves(tcache)):
            for b in idle:
                assert torch.equal(old[:, b], new[:, b])
        offs += nl
    assert (offs == [7, 5, 0]).all()
    _cache_close(tcache, jcache, arch)

    tok = np.asarray([[p[-1]] for p in prompts], np.int32)
    jtok, ttok = _j(tok), _t(tok)
    for step in range(4):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jtok, "lengths": _j(lengths)}, jcache)
        tlog, tcache = tb.decode_step(tparams, {"tokens": ttok,
                                                "lengths": _t(lengths)}, tcache)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _cache_close(tcache, jcache, arch)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_whole_prompt_prefill_matches_reference(arch):
    jb, jparams, tb, tparams = _bundles(arch)
    B, S, max_len = 2, 12, 16
    toks = np.random.default_rng(1).integers(0, jb.cfg.vocab, (B, S)).astype(np.int32)
    jlog, jcache = jb.prefill(jparams, {"tokens": _j(toks)}, jb.init_cache(B, max_len))
    tlog, tcache = tb.prefill(tparams, {"tokens": _t(toks)},
                              tb.init_cache(B, max_len, device="cpu"))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    _cache_close(tcache, jcache, arch)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_server_tokens_match_reference_oversubscribed(arch):
    jb, jparams, tb, tparams = _bundles(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jb.cfg.vocab, n).astype(np.int32)
               for n in (9, 14, 3, 6, 1)]
    jserver = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=64,
                                           prefill_chunk=4), jparams)
    tserver = Server(tb, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4),
                     tparams, device="cpu")
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    jserver.add_requests(jreqs)
    tserver.add_requests(treqs)
    jserver.run_until_done(max_steps=300)
    tserver.run_until_done(max_steps=300)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.out_tokens) == 5
        assert tr.out_tokens == jr.out_tokens, tr.rid
    assert tserver.stats()["decode_tokens"] == jserver.stats()["decode_tokens"]


def test_single_token_prompt_after_slot_reuse_matches_fresh():
    """A 1-token prompt still resets a reused slot's recurrent state: the
    admission dispatch runs with nothing to write and zeroes offset-0 rows
    (tests/test_serve_fastpath.py:438-462), here against the reference."""
    jb, jparams, tb, tparams = _bundles("mamba2-780m")
    cfg = dict(batch_slots=1, max_len=32, prefill_chunk=4)

    def serve(server, req):
        server.add_request(req)
        server.run_until_done(max_steps=200)
        return req.out_tokens

    dirty = Server(tb, ServeConfig(**cfg), tparams, device="cpu")
    serve(dirty, Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=6))
    dispatches = dirty.stats()["prefill_dispatches"]
    got = serve(dirty, Request(rid=1, prompt=np.asarray([5], np.int32), max_new_tokens=5))
    assert dirty.stats()["prefill_dispatches"] == dispatches + 1
    fresh = Server(tb, ServeConfig(**cfg), tparams, device="cpu")
    want = serve(fresh, Request(rid=0, prompt=np.asarray([5], np.int32), max_new_tokens=5))
    jserver = JaxServer(jb, JaxServeConfig(**cfg), jparams)
    ref_tokens = serve(jserver, JaxRequest(rid=0, prompt=np.asarray([5], np.int32),
                                           max_new_tokens=5))
    assert got == want == ref_tokens


# ---------------------------------------------------------------------------
# dtypes, conversion, what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_caches_from_jax_keeps_the_f32_state_pin(arch):
    jb = JaxBundle(jax_smoke_config(arch))
    tb = ModelBundle(smoke_config(arch))
    jcache = jax.tree.map(np.asarray, jb.init_cache(2, 16))        # bf16 model
    defs = tb.cache_defs(2, 16)
    tcache = convert.caches_from_jax(jcache, "cpu", "bfloat16", defs=defs)
    leaf = tcache["stages"][0]["0M"]
    assert leaf["ssm"].dtype == torch.float32
    assert leaf["conv"].dtype == torch.bfloat16
    if arch == "zamba2-1.2b":
        assert tcache["stages"][0]["5S"]["k"].dtype == torch.bfloat16
    # the dtypes the reference itself gives every leaf
    tree_map(_same_dtype, tcache, jcache)
    with pytest.raises(ValueError, match="cache defs"):
        convert.caches_from_jax(jcache, "cpu", "bfloat16")


def _same_dtype(t, j):
    assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_cache_pins_the_ssm_state_to_f32(arch):
    tb = ModelBundle(smoke_config(arch))                          # bf16 model
    assert tb.cfg.dtype == "bfloat16"
    cache = tb.init_cache(2, 16, device="cpu")
    for stage in cache["stages"]:
        for key, leaf in stage.items():
            if key.endswith("M"):
                assert leaf["ssm"].dtype == torch.float32
                assert leaf["conv"].dtype == torch.bfloat16
            else:
                assert leaf["k"].dtype == torch.bfloat16


def test_bf16_smoke_serves_on_cpu():
    """A bf16 mamba2 smoke model serves (the f32 state under a bf16 model)."""
    tb = ModelBundle(smoke_config("mamba2-780m"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    server = Server(tb, ServeConfig(batch_slots=2, max_len=32, prefill_chunk=8),
                    params, device="cpu")
    reqs = [Request(rid=i, prompt=np.arange(1, 2 + 5 * i, dtype=np.int32),
                    max_new_tokens=4) for i in range(3)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=100)
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert server.engine.caches["stages"][0]["0M"]["ssm"].dtype == torch.float32


def test_shared_block_defs_match_reference():
    jb = JaxBundle(jax_smoke_config("zamba2-1.2b"))
    tb = ModelBundle(smoke_config("zamba2-1.2b"))
    want = jax.tree.map(lambda p: tuple(p.shape), jb.param_defs()["shared_attn"],
                        is_leaf=lambda p: hasattr(p, "axes"))
    got = tree_map(lambda p: tuple(p.shape), tb.param_defs()["shared_attn"])
    assert got == want
    d = tb.cfg.d_model
    assert got["w_q"][0] == 2 * d and got["w_o"][-1] == d
