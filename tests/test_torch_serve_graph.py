"""The step functions the serve graphs capture, on the CPU.

On the card the Executor captures ``_decode_step`` and ``_prefill_step``
as CUDA graphs and replays them; a replay reads and writes the addresses
seen at capture.  So both must read and write only the Executor's fixed
buffers (the device state, the prefill inputs, the packed result) and the
caches, and those must never move.  Here the same functions run eagerly,
as the CPU runs them:

* the buffers' and caches' ``data_ptr`` stay fixed over admissions and
  retirements, and the params are left bit for bit;
* a step rebinds no buffer and returns nothing (no tensor escapes);
* two calls on the same inputs give identical buffers and caches;
* a prefill dispatch leaves the cache of rows with ``new_lens == 0`` bit
  for bit;
* an oversubscribed greedy run gives the reference ``Server``'s tokens
  per rid (dense and hybrid), with the pointers checked after every step;
* on the CPU nothing is captured and the eager flag changes nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["yi-6b", "zamba2-1.2b"]


def _pair(arch):
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _fixed(engine) -> dict[str, torch.Tensor]:
    """Every tensor a captured step reads or writes, by name."""
    out = {f"state.{k}": v for k, v in engine.state.buffers.items()}
    out.update({f"prefill.{k}": v for k, v in engine.prefill_in.items()})
    out["out"] = engine.out
    out.update({f"cache.{i}": t for i, t in enumerate(tree_leaves(engine.caches))})
    return out


def _ptrs(engine) -> dict[str, int]:
    return {k: t.data_ptr() for k, t in _fixed(engine).items()}


def _snapshot(engine) -> dict[str, torch.Tensor]:
    return {k: t.clone() for k, t in _fixed(engine).items()}


def _restore(engine, snap) -> None:
    for k, t in _fixed(engine).items():
        t.copy_(snap[k])


def _server(arch="yi-6b", slots=3, max_len=48, chunk=4, **kw):
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    return Server(tb, ServeConfig(batch_slots=slots, max_len=max_len,
                                  prefill_chunk=chunk), params, device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_tokens_match_reference_with_fixed_buffers(arch):
    jb, jparams, tb, tparams = _pair(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, jb.cfg.vocab, n).astype(np.int32)
               for n in (9, 14, 3, 6, 1, 7)]
    jserver = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=64,
                                           prefill_chunk=4), jparams)
    tserver = Server(tb, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4),
                     tparams, device="cpu")
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jserver.add_requests(jreqs)
    tserver.add_requests(treqs)
    jserver.run_until_done(max_steps=300)
    ptrs = _ptrs(tserver.engine)
    params = [t.clone() for t in tree_leaves(tparams)]
    steps = 0
    while tserver.has_work():
        tserver.step()
        steps += 1
        assert _ptrs(tserver.engine) == ptrs, f"a buffer moved at step {steps}"
    assert steps < 300
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.out_tokens == jr.out_tokens, tr.rid
    for a, b in zip(params, tree_leaves(tparams)):
        assert torch.equal(a, b)
    st = tserver.stats()
    assert st["decode_replays"] == st["prefill_replays"] == 0   # nothing captured


@pytest.mark.parametrize("step", ["_decode_step", "_prefill_step"])
def test_step_rebinds_nothing_and_returns_nothing(step):
    server = _server()
    server.submit(np.arange(1, 9), max_new_tokens=4)
    server.submit(np.arange(3, 6), max_new_tokens=4)
    server.step()                        # admission, then one decode step
    eng = server.engine
    fixed = _fixed(eng)
    ptrs = _ptrs(eng)
    assert getattr(eng, step)() is None
    after = _fixed(eng)
    assert after.keys() == fixed.keys()
    assert all(after[k] is fixed[k] for k in fixed), "a step rebound a buffer"
    assert _ptrs(eng) == ptrs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", ["_decode_step", "_prefill_step"])
def test_two_calls_on_the_same_inputs_are_identical(arch, step):
    server = _server(arch)
    for n in (5, 11):
        server.submit(np.arange(1, 1 + n), max_new_tokens=6)
    server.step()
    server.step()
    eng = server.engine
    rng = np.random.default_rng(0)
    eng.prefill_in["tokens"].copy_(torch.from_numpy(
        rng.integers(1, server.bundle.cfg.vocab, eng.prefill_in["tokens"].shape)
        .astype(np.int32)))
    eng.prefill_in["new_lens"].copy_(torch.tensor([4, 2, 0], dtype=torch.int32))
    eng.prefill_in["offsets"].copy_(eng.state["lengths"])
    snap = _snapshot(eng)
    getattr(eng, step)()
    first = _snapshot(eng)
    _restore(eng, snap)
    getattr(eng, step)()
    second = _snapshot(eng)
    changed = [k for k in first if not torch.equal(first[k], snap[k])]
    assert changed, "the step wrote nothing"
    for k in first:
        assert torch.equal(first[k], second[k]), k


def test_prefill_step_leaves_rows_without_new_tokens_bit_for_bit():
    server = _server(slots=3)
    for n in (9, 6, 12):
        server.submit(np.arange(1, 1 + n), max_new_tokens=3)
    server.step()
    eng = server.engine
    eng.prefill_in["tokens"].fill_(7)
    eng.prefill_in["new_lens"].copy_(torch.tensor([0, 3, 0], dtype=torch.int32))
    eng.prefill_in["offsets"].copy_(eng.state["lengths"])
    before = [t.clone() for t in tree_leaves(eng.caches)]
    eng._prefill_step()
    moved = False
    for old, new in zip(before, tree_leaves(eng.caches)):
        # every cache leaf is stacked (layers, batch, ...)
        for row in (0, 2):
            assert torch.equal(old[:, row], new[:, row])
        moved |= not torch.equal(old[:, 1], new[:, 1])
    assert moved, "the row with new tokens was not written"


def test_decode_step_advances_only_active_rows():
    server = _server(slots=3)
    server.submit(np.arange(1, 6), max_new_tokens=5)
    server.step()
    eng = server.engine
    lengths = eng.state["lengths"].clone()
    tokens = eng.state["tokens"].clone()
    active = eng.state["active"].clone()
    assert active.tolist() == [True, False, False]
    eng._decode_step()
    assert torch.equal(eng.state["lengths"], lengths + active.to(torch.int32))
    assert torch.equal(eng.state["tokens"][1:], tokens[1:])
    assert torch.equal(eng.out[0, :1], eng.state["tokens"][:1, 0])
    assert eng.out[1].tolist() == [0, 0, 0]


def test_cpu_runs_eagerly_whatever_the_flag():
    a, b = _server(), _server(eager=True)
    for server in (a, b):
        assert not server.engine.graphed and server.engine.graph_launches == {}
        for n in (4, 9, 2, 7):
            server.submit(np.arange(1, 1 + n), max_new_tokens=3)
        server.run_until_done(max_steps=100)
    assert a.stats() | {"prefill_s": 0, "decode_s": 0} == \
        b.stats() | {"prefill_s": 0, "decode_s": 0}
    assert a.engine.measured_step_s is not None and a.engine.measured_step_s > 0


def test_measured_step_s_skips_the_first_step():
    server = _server()
    server.submit(np.arange(1, 5), max_new_tokens=3)
    server.step()
    assert server.engine.measured_step_s is None
    server.step()
    first = server.engine.measured_step_s
    assert first is not None and first > 0
    server.step()
    assert server.engine.measured_step_s != first
