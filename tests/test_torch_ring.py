"""The ring-cache attention layers (``L``, ``G``, ``C``) vs the JAX reference.

An ``L`` (sliding-window) cache is a ring of ``min(max_len, window)``
slots and a ``C`` (chunk-local) cache a ring of ``min(max_len, 2 *
chunk)``; position ``p`` lives at slot ``p % size``.  A ``G`` (global)
layer keeps ``max_len`` slots and takes its own RoPE base.

* the ring helpers (``_ring_positions``, ``_append_kv``) against the
  reference's, with rings shorter than, equal to and longer than a chunk,
  offsets that wrap and rows that write nothing (bit for bit);
* ``gqa_prefill_at`` and ``gqa_decode`` for each code against the
  reference's (``C`` decode only while a row is in its first chunk: past
  it the reference masks a ``C`` ring by slot, not by position, ROADMAP
  C1), and ``C`` decode past its first chunk against the port's own
  full-sequence ``gqa_train`` under the ``chunked`` mask; one test
  records that the reference differs there;
* gemma3-27b-smoke (``LLLLLG`` + ``LL``, window 32) through ``ModelBundle``
  and ``Server`` against the reference's, with prompts that wrap the
  rings, one training loss and its grads, 3 AdamW steps, host
  placements and preemption with ring slots;
* a test-only dense ``CCCG`` config (llama4-smoke's attention, chunk 16,
  no MoE) built in both packages.

Everything runs in float32 on the CPU (the plain attention paths);
inputs come from numpy seeds.  Tolerances: logits and caches atol/rtol
1e-4 (``tests/test_torch_model.py``), gradients as
``tests/test_torch_train.py`` holds them, greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.mesh import make_mesh_for as jax_mesh_for
from repro.models import attention as jattn
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_config, smoke_config
from repro_torch.core.placement import Role, parse_policy
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.serve import Request, ServeConfig, Server
from repro_torch.train import TrainConfig, make_train_step

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "gemma3-27b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), **(kw or TOL)
    )


# ---------------------------------------------------------------------------
# the ring helpers
# ---------------------------------------------------------------------------

#: ring sizes against a chunk of 8 tokens: shorter, equal, longer
RING_SIZES = [5, 8, 13]


@pytest.mark.parametrize("size", RING_SIZES)
def test_ring_positions_match_reference(size):
    offs = np.asarray([0, 1, 4, 5, 8, 13, 27, 40], np.int32)
    want = np.asarray(jattn._ring_positions(jnp.asarray(offs), size))
    got = tattn._ring_positions(_t(offs), size).numpy()
    np.testing.assert_array_equal(got, want)
    # each slot holds p = slot (mod size), the newest below the offset
    r = np.arange(size)
    assert ((got % size) == r).all()
    assert ((got < offs[:, None]) & (got >= offs[:, None] - size)).all()


@pytest.mark.parametrize("size", RING_SIZES)
@pytest.mark.parametrize("offsets,new_lens", [
    ([0, 3, 6, 2], [8, 8, 0, 5]),        # from empty, one row writes nothing
    ([9, 12, 21, 35], [8, 3, 8, 0]),     # every row past the ring: wraps
    ([4, 7, 0, 11], [1, 8, 8, 6]),       # a single token, a chunk across the seam
])
def test_append_kv_matches_reference(size, offsets, new_lens):
    rng = np.random.default_rng(size)
    B, H, S, D = 4, 2, 8, 4
    cache = {n: rng.normal(size=(B, H, size, D)).astype(np.float32) for n in ("k", "v")}
    k_new, v_new = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(2))
    offs, nl = np.asarray(offsets, np.int32), np.asarray(new_lens, np.int32)
    want = jattn._append_kv({n: jnp.asarray(c) for n, c in cache.items()},
                            jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(offs), jnp.asarray(nl))
    got = {n: _t(c) for n, c in cache.items()}
    tattn._append_kv(got, _t(k_new), _t(v_new), _t(offs), _t(nl))
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    for b in np.flatnonzero(nl == 0):
        np.testing.assert_array_equal(got["k"][b].numpy(), cache["k"][b])


# ---------------------------------------------------------------------------
# one attention block per code
# ---------------------------------------------------------------------------

#: window and chunk 8 on a cache of 32 positions: an L ring of 8 slots, a
#: C ring of 16, a G cache of 32 with its own RoPE base
SPEC = dict(n_heads=4, n_kv_heads=2, d_head=16, qk_norm=True, rope_theta=10_000.0,
            rope_theta_global=1_000_000.0, window=8, chunk=8)
D_MODEL, MAX_LEN = 32, 32


def _block(code, seed=0):
    """The block's params (numpy), its spec in both packages and an empty
    cache of each package for 3 rows."""
    jspec, tspec = jconfigs.AttentionSpec(**SPEC), tconfigs.AttentionSpec(**SPEC)
    rng = np.random.default_rng(seed)
    params = {}
    for name, p in tattn.attention_defs(D_MODEL, tspec).items():
        params[name] = (np.ones(p.shape, np.float32) if p.init == "ones"
                        else rng.normal(size=p.shape).astype(np.float32) * 0.3)
    defs = tattn.cache_defs(3, MAX_LEN, tspec, code)
    shape = defs["k"].shape
    assert shape[2] == {"L": 8, "C": 16, "G": MAX_LEN}[code]
    jcache = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
    tcache = {n: torch.zeros(shape) for n in ("k", "v")}
    return params, jspec, tspec, jcache, tcache


#: per-row fills of chunks of 6: the rings wrap inside a chunk and across
#: chunks, and a row writes nothing now and then (offsets end at 23, 18, 15)
LONG_FILLS = [[6, 6, 3], [6, 0, 6], [5, 6, 6], [6, 6, 0]]


@pytest.mark.parametrize("code,fills,steps", [
    ("L", LONG_FILLS, 4),
    ("G", LONG_FILLS, 4),
    ("C", LONG_FILLS, 0),                # prefill_at masks by position in both
    ("C", [[3, 2, 4], [1, 0, 1]], 3),    # decode only inside the first chunk
])
def test_prefill_at_then_decode_match_reference(code, fills, steps):
    """Three rows fed chunks of 6 at their own offsets, then decode steps:
    outputs and caches equal the reference's.  ``C`` decodes only while
    every row is in its first chunk, where the reference's slot-prefix
    rule is the position mask."""
    params, jspec, tspec, jcache, tcache = _block(code)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    rng = np.random.default_rng(1)
    S = 6
    offs = np.zeros(3, np.int32)
    for nl in fills:
        nl = np.asarray(nl, np.int32)
        x = rng.normal(size=(3, S, D_MODEL)).astype(np.float32)
        want, jcache = jattn.gqa_prefill_at(jp, jnp.asarray(x), jcache, jnp.asarray(offs),
                                            jnp.asarray(nl), jspec, code)
        got = tattn.gqa_prefill_at(tp, _t(x), tcache, _t(offs), _t(nl), tspec, code)
        for b in np.flatnonzero(nl):
            _close(got[b, :nl[b]], np.asarray(want)[b, :nl[b]])
        offs += nl
    if fills is LONG_FILLS:
        assert offs.max() > tcache["k"].shape[2] or code == "G"   # the ring wrapped
    for _ in range(steps):
        x = rng.normal(size=(3, 1, D_MODEL)).astype(np.float32)
        want, jcache = jattn.gqa_decode(jp, jnp.asarray(x), jcache, jnp.asarray(offs),
                                        jspec, code)
        got = tattn.gqa_decode(tp, _t(x), tcache, _t(offs), tspec, code)
        _close(got, want)
        offs += 1
    if code == "C" and steps:
        assert offs.max() <= 8             # the last decode was at position 7
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])


def _decode_against_train(code, T, prefill=0, seed=2):
    """Run one row of ``T`` positions through ``gqa_prefill_at`` (the first
    ``prefill``) and then ``gqa_decode`` one token at a time; return (the
    outputs, the port's ``gqa_train`` over the whole sequence)."""
    params, _, tspec, _, tcache = _block(code, seed)
    tp = {k: _t(v) for k, v in params.items()}
    cache = {n: t[:1].clone() for n, t in tcache.items()}
    x = _t(np.random.default_rng(seed).normal(size=(1, T, D_MODEL)).astype(np.float32))
    outs = []
    if prefill:
        nl = torch.tensor([prefill], dtype=torch.int32)
        outs.append(tattn.gqa_prefill_at(tp, x[:, :prefill], cache,
                                         torch.zeros(1, dtype=torch.int32), nl, tspec, code))
    for t in range(prefill, T):
        outs.append(tattn.gqa_decode(tp, x[:, t:t + 1], cache,
                                     torch.tensor([t], dtype=torch.int32), tspec, code))
    return torch.cat(outs, 1), tattn.gqa_train(tp, x, tspec, code)


@pytest.mark.parametrize("code,prefill", [("C", 0), ("C", 13), ("L", 0), ("L", 11)])
def test_decode_past_the_first_chunk_matches_full_recompute(code, prefill):
    """Past its first chunk (and past the ring's end, 3 chunks and more),
    ``C`` decode attends by position and equals the full-sequence
    attention under the ``chunked`` mask; ``L`` the same under the
    ``sliding`` mask."""
    got, want = _decode_against_train(code, T=3 * 8 + 5, prefill=prefill)
    _close(got, want)


def test_reference_c_decode_differs_past_the_first_chunk():
    """ROADMAP C1, recorded: the reference's ``gqa_decode`` masks a ``C``
    ring to its first ``lengths % chunk + 1`` slots, which is the current
    chunk only in a row's first chunk.  Below it the reference equals its
    own full-sequence attention; past it it does not, where the port does
    (previous test)."""
    params, jspec, _, jcache, _ = _block("C", seed=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    T = 3 * 8 + 5
    x = np.random.default_rng(2).normal(size=(1, T, D_MODEL)).astype(np.float32)
    want = np.asarray(jattn.gqa_train(jp, jnp.asarray(x), jspec, "C"))[0]
    cache = {n: c[:1] for n, c in jcache.items()}
    err = []
    for t in range(T):
        out, cache = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]), cache,
                                      jnp.asarray([t], jnp.int32), jspec, "C")
        err.append(float(np.abs(np.asarray(out)[0, 0] - want[t]).max()))
    err = np.asarray(err)
    assert err[:8].max() < 1e-4                    # first chunk: the same
    assert (err[8:] > 1e-2).sum() >= 8             # past it: another chunk's keys


# ---------------------------------------------------------------------------
# gemma3-27b-smoke through the bundle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(ARCH), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(ARCH), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _caches_close(tcache, jcache):
    jl, tl = jax.tree.leaves(jcache), tree_leaves(tcache)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j)


def test_gemma3_bundle_builds_and_sizes_its_rings():
    """The full config builds; its stages; a slot holds 52 L layers of
    1024 positions and 10 G layers of 2048 (not 62 of 2048)."""
    tb = ModelBundle(get_config(ARCH))
    assert tb.cfg.stages() == [("LLLLLG", 10, 0), ("LL", 1, 60)]
    per_pos = 2 * 16 * 128 * 2                     # k and v, 16 KV heads, bf16
    assert tb.cache_bytes_for(1, 2048) == (52 * 1024 + 10 * 2048) * per_pos == 603_979_776
    defs = tb.cache_defs(8, 2048)["stages"]
    assert [d["k"].shape[3] for d in defs[0].values()] == [1024] * 5 + [2048]
    assert [d["k"].shape[3] for d in defs[1].values()] == [1024, 1024]
    # the planner's decode price reads these bytes (a preemption prices
    # Executor.slot_bytes(): test_gemma3_preempted_ring_slots_keep_their_tokens)
    prof = tb.decode_workload(ShapeSpec("serve", 2048, 8, "decode"))
    assert prof.bytes_per_role[Role.KV_CACHE] == 8 * 603_979_776


@pytest.mark.parametrize("arch,item", [("deepseek-v2-236b", "A4b")])
def test_moe_and_mla_still_refused_naming_their_item(arch, item):
    """Ported by ``item`` and no longer refused: deepseek-v2 builds, and
    its layout holds a lead stage of one dense layer and an MLA cache of
    the latent and the rope key per layer (576 bf16 a position)."""
    tb = ModelBundle(get_config(arch))
    lead = tb.cfg.moe.first_k_dense
    assert [(c, n) for c, n, _ in tb.cfg.stages()] == [("F", lead), ("F", 60 - lead)]
    defs = tb.cache_defs(8, 2048)["stages"]
    assert [tuple(d["0F"]["ckv"].shape) for d in defs] == [(1, 8, 2048, 512),
                                                          (59, 8, 2048, 512)]
    assert tb.cache_bytes_for(1, 2048) == 60 * 2048 * (512 + 64) * 2


def test_gemma3_prefill_matches_reference(gemma):
    """Whole-prompt prefill of 40 tokens (past the window of 32: the L
    rings keep the last 32) and decode steps after it."""
    jb, jparams, tb, tparams = gemma
    toks = np.random.default_rng(3).integers(0, jb.cfg.vocab, (2, 40)).astype(np.int32)
    jlog, jcache = jb.prefill(jparams, {"tokens": jnp.asarray(toks)},
                              jb.init_cache(2, 64, "float32"))
    tcache = tb.init_cache(2, 64, dtype="float32", device="cpu")
    tlog, _ = tb.prefill(tparams, {"tokens": _t(toks)}, tcache)
    _close(tlog, jlog)
    _caches_close(tcache, jcache)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for step in range(3):
        lengths = np.full(2, 40 + step, np.int32)
        jlog, jcache = jb.decode_step(jparams, {"tokens": jnp.asarray(tok),
                                                "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


def test_gemma3_prefill_at_then_decode_match_reference(gemma):
    """Chunks of 8 at per-row offsets (prompts of 60, 45 and 9 tokens: the
    L rings wrap in prefill), then 40 greedy decode steps (past 96
    positions: every L ring wraps again); logits, tokens and caches."""
    jb, jparams, tb, tparams = gemma
    B, chunk = 3, 8
    jcache, tcache = jb.init_cache(B, 128, "float32"), tb.init_cache(B, 128, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jb.cfg.vocab, n).astype(np.int32) for n in (60, 45, 9)]
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
    for step in range(40):
        lengths = offs + step
        jlog, jcache = jdec(jparams, {"tokens": jnp.asarray(tok),
                                      "lengths": jnp.asarray(lengths)}, jcache)
        tlog, _ = tb.decode_step(tparams, {"tokens": _t(tok), "lengths": _t(lengths)},
                                 tcache)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tlog, -1).numpy(), tok[:, 0])
    _caches_close(tcache, jcache)


def test_gemma3_loss_and_grads_match_reference(gemma):
    jb, jparams, tb, tparams = gemma
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jb.cfg.vocab, (2, 48)).astype(np.int32)   # past the window
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jb.train_loss(p, jbatch, remat="full"), has_aux=True)(jparams)
    tparams = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    leaves = tree_leaves(tparams)
    got, _ = tb.train_loss(tparams, {k: _t(v) for k, v in batch.items()}, remat="full")
    it = iter(torch.autograd.grad(got, leaves))
    _close(got, want, atol=1e-5, rtol=1e-5)
    tree_map(lambda g, w: _close(g, w, rtol=1e-4,
                                 atol=2e-4 * max(float(np.abs(w).max()), 1e-6)),
             tree_map(lambda _: next(it), tparams), jgrads)


def test_gemma3_train_steps_match_reference(gemma):
    """3 AdamW steps of gemma3-smoke (4 x 48 tokens, past the window of
    32) from the reference's initial state, carried across, at
    ``tests/test_torch_train.py``'s limits: step 1's loss at 1e-5, later
    losses at 1e-4, grad norms at 1e-4, every weight within 2 x the summed
    lr_t of the reference's and the 99th percentile within 1e-5."""
    jb, _, tb, _ = gemma
    lr, warmup = 1e-3, 2
    mesh = jax_mesh_for((1,), ("data",))
    jtcfg = JaxTrainConfig(remat="full",
                           optimizer=JaxAdamWConfig(lr=lr, warmup_steps=warmup))
    jparams, jopt, jef = jax_init_train_state(jb, mesh, jax.random.PRNGKey(0), jtcfg)
    params, opt = convert.params_from_jax(jax.tree.map(np.asarray, (jparams, jopt)), "cpu")
    jstep = jax.jit(jax_make_train_step(jb, mesh, jtcfg))
    step = make_train_step(tb, TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=lr, warmup_steps=warmup)))
    data = SyntheticLM(DataConfig(vocab=tb.cfg.vocab, seq_len=48, global_batch=4))
    lr_sum = 0.0
    for i in range(3):
        batch = next(data)
        jparams, jopt, jef, jm = jstep(jparams, jopt, jef,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, _, m = step(params, opt, None, {k: _t(v) for k, v in batch.items()})
        lr_sum += lr * min((i + 1) / warmup, 1.0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        diffs = []
        tree_map(lambda g, w: diffs.append(np.abs(g.numpy() - np.asarray(w)).ravel()),
                 params, jparams)
        diffs = np.concatenate(diffs)
        assert diffs.max() <= 2 * lr_sum * 1.1, (i, diffs.max())
        assert np.quantile(diffs, 0.99) <= 1e-5, (i, np.quantile(diffs, 0.99))


def _gemma_prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in (40, 90, 55, 71, 63)]


def _port_tokens(tb, tparams, prompts, new=6, arrivals=False, **kw):
    server = Server(tb, ServeConfig(batch_slots=2, max_len=128, prefill_chunk=8, **kw),
                    tparams, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    pending, tick = list(reqs), 0
    while pending or server.has_work():
        while pending and (not arrivals or tick >= 2 * (len(reqs) - len(pending))):
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        assert tick < 2000
    assert all(r.done and len(r.out_tokens) == new for r in reqs)
    return server, [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def gemma_tokens(gemma):
    """The reference ``Server``'s greedy tokens for the prompts of 40-90
    tokens (2 slots x 128, chunk 8)."""
    jb, jparams, _, _ = gemma
    server = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=128, prefill_chunk=8),
                       jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_gemma_prompts(jb.cfg.vocab))]
    server.add_requests(reqs)
    server.run_until_done(max_steps=500)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("policy", ["hbm_resident", "kv_host", "kv=host", "weights_stream"])
def test_gemma3_server_tokens_match_reference(gemma, gemma_tokens, policy):
    """The port's ``Server`` under each placement (the KV write-back wraps
    modulo each leaf's own ring) gives the reference's tokens."""
    _, _, tb, tparams = gemma
    server, got = _port_tokens(tb, tparams, _gemma_prompts(tb.cfg.vocab), policy=policy)
    assert server.policy.name == parse_policy(policy).name
    assert got == gemma_tokens


def test_gemma3_preempted_ring_slots_keep_their_tokens(gemma, gemma_tokens):
    """Arrivals one every 2 ticks into 2 slots with preemption: ring slots
    spill (rows of 32 and 128 positions) and come back, tokens unchanged;
    a slot's bytes are the rings'."""
    _, _, tb, tparams = gemma
    server, got = _port_tokens(tb, tparams, _gemma_prompts(tb.cfg.vocab), arrivals=True,
                               preempt=True, preempt_wait=2, verify_spills=True)
    st = server.stats()
    assert got == gemma_tokens
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    assert st["spill_corruptions"] == 0
    a = tb.cfg.attention                 # 7 L rings of 32, one G cache of 128, f32
    assert server.engine.slot_bytes() == (7 * 32 + 128) * 2 * a.n_kv_heads * a.d_head * 4


# ---------------------------------------------------------------------------
# a dense CCCG config (llama4-smoke's attention, no MoE)
# ---------------------------------------------------------------------------

def _cccg(pkg):
    return pkg.ArchConfig(
        name="cccg-smoke", family="dense", n_layers=4, d_model=64, d_ff=128, vocab=512,
        layer_pattern="CCCG", norm="rmsnorm",
        attention=pkg.AttentionSpec(n_heads=4, n_kv_heads=2, d_head=16, chunk=16),
        act="silu", dtype="float32")


@pytest.fixture(scope="module")
def cccg():
    jb, tb = JaxBundle(_cccg(jconfigs)), ModelBundle(_cccg(tconfigs))
    jparams = jb.init_params(jax.random.PRNGKey(1), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _cccg_serve(tb, tparams, prompts, new):
    server = Server(tb, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4), tparams,
                    device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=500)
    return [r.out_tokens for r in reqs]


def test_cccg_tokens_match_reference_within_the_first_chunk(cccg):
    """Prompt + new tokens stay below the chunk of 16: the reference's
    slot-prefix rule is the position mask there, so tokens agree."""
    jb, jparams, tb, tparams = cccg
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (5, 9, 3, 10)]
    server = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=64, prefill_chunk=4),
                       jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=500)
    assert max(len(p) + 5 for p in prompts) <= 16
    assert _cccg_serve(tb, tparams, prompts, 5) == [r.out_tokens for r in reqs]


def test_cccg_tokens_past_the_chunk_match_full_recompute(cccg):
    """Past the chunk (and past the 32-slot ring) each greedy token is the
    argmax of the port's own full-sequence forward over prompt + the
    tokens before it."""
    _, _, tb, tparams = cccg
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (20, 31, 14)]
    got = _cccg_serve(tb, tparams, prompts, 12)
    with torch.no_grad():
        for p, out in zip(prompts, got):
            seq = list(p)
            for tok in out:
                logits, _ = ttf.lm_forward(tparams, _t(np.asarray([seq], np.int32)), tb.cfg)
                assert int(torch.argmax(logits[0, -1])) == tok
                seq.append(tok)
    assert max(len(p) + 12 for p in prompts) > 32
