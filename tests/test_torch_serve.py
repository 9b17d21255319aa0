"""The port's serve stack vs the JAX reference's, on the CPU.

* greedy tokens per rid from the port's ``Server`` equal the reference
  ``Server``'s with more requests than slots (same weights, carried across);
* ``add_request`` rejects what the reference rejects, with its messages;
* ``filter_logits`` keeps the set :func:`filter_logits_ref` keeps;
* a sampled request is a function of (seed, position): the same tokens
  twice, whatever else shares the batch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import QueueFullError as JaxQueueFullError
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro.serve.sampling import filter_logits_ref as jax_filter_logits_ref
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core.placement import DonorAxisError
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.serve import (
    QueueFullError,
    Request,
    SamplingParams,
    ServeConfig,
    ServeHangError,
    Server,
)
from repro_torch.serve.sampling import (
    filter_logits,
    filter_logits_ref,
    sample_tokens,
    uniforms,
)

jax.config.update("jax_platform_name", "cpu")


def _pair(arch):
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b", "granite-8b"])
def test_server_tokens_match_reference_oversubscribed(arch):
    jb, jparams, tb, tparams = _pair(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jb.cfg.vocab, n).astype(np.int32)
               for n in (9, 14, 3, 6, 1)]
    jserver = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=64,
                                           prefill_chunk=4), jparams)
    tserver = Server(tb, ServeConfig(batch_slots=2, max_len=64,
                                     prefill_chunk=4), tparams, device="cpu")
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jserver.add_requests(jreqs)
    tserver.add_requests(treqs)
    assert tserver.queue_depth == jserver.queue_depth == 5
    jserver.run_until_done(max_steps=300)
    tserver.run_until_done(max_steps=300)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.out_tokens) == 5
        assert tr.out_tokens == jr.out_tokens, tr.rid
    st = tserver.stats()
    assert st["decode_tokens"] == jserver.stats()["decode_tokens"]
    assert st["prefill_dispatches"] >= 3 and st["decode_steps"] > 0
    tp = tserver.throughput()
    assert tp["decode_tokens"] == 25 and tp["decode_tps"] > 0


def _bad_requests(req_cls, sp_cls):
    p = np.arange(1, 4, dtype=np.int32)
    return [
        req_cls(rid=-1, prompt=p, max_new_tokens=2),
        req_cls(rid=7, prompt=p, max_new_tokens=2),          # duplicate
        req_cls(rid=1, prompt=p, max_new_tokens=0),
        req_cls(rid=2, prompt=np.zeros(0, np.int32), max_new_tokens=2),
        req_cls(rid=3, prompt=np.arange(16, dtype=np.int32), max_new_tokens=2),
        req_cls(rid=4, prompt=p, max_new_tokens=2,
                sampling=sp_cls(temperature=-1.0)),
        req_cls(rid=4, prompt=p, max_new_tokens=2, sampling=sp_cls(top_p=0.0)),
        req_cls(rid=4, prompt=p, max_new_tokens=2, sampling=sp_cls(top_k=-2)),
        req_cls(rid=4, prompt=p, max_new_tokens=2, sampling=sp_cls(seed=2**32)),
        req_cls(rid=4, prompt=p, max_new_tokens=2,
                sampling=sp_cls(stop_tokens=(1, 2, 3, 4, 5))),
        req_cls(rid=4, prompt=p, max_new_tokens=2,
                sampling=sp_cls(stop_tokens=(-3,))),
    ]


def test_add_request_validation_matches_reference():
    jb, jparams, tb, tparams = _pair("olmo-1b")
    jserver = JaxServer(jb, JaxServeConfig(batch_slots=1, max_len=16,
                                           max_queue=2), jparams)
    tserver = Server(tb, ServeConfig(batch_slots=1, max_len=16, max_queue=2),
                     tparams, device="cpu")
    p = np.arange(1, 4, dtype=np.int32)
    jserver.add_request(JaxRequest(rid=7, prompt=p, max_new_tokens=2))
    tserver.add_request(Request(rid=7, prompt=p, max_new_tokens=2))
    cases = zip(_bad_requests(JaxRequest, JaxSamplingParams),
                _bad_requests(Request, SamplingParams))
    for jreq, treq in cases:
        with pytest.raises(ValueError) as jerr:
            jserver.add_request(jreq)
        with pytest.raises(ValueError) as terr:
            tserver.add_request(treq)
        assert str(terr.value) == str(jerr.value)
    # backpressure: the bounded queue raises on both sides
    jserver.add_request(JaxRequest(rid=8, prompt=p, max_new_tokens=2))
    tserver.add_request(Request(rid=8, prompt=p, max_new_tokens=2))
    with pytest.raises(JaxQueueFullError) as jerr:
        jserver.add_request(JaxRequest(rid=9, prompt=p, max_new_tokens=2))
    with pytest.raises(QueueFullError) as terr:
        tserver.add_request(Request(rid=9, prompt=p, max_new_tokens=2))
    assert str(terr.value) == str(jerr.value)
    assert tserver.live_rids == jserver.live_rids == (7, 8)


def test_unported_policy_and_hang_raise():
    # host placements serve (tests/test_torch_placed_serve.py,
    # tests/test_torch_resident_host.py); a peer tier needs a donor axis
    ServeConfig(policy="kv_host")
    ServeConfig(policy="hbm_resident")
    tb = ModelBundle(smoke_config("olmo-1b"))
    params = tb.init_params(torch.Generator().manual_seed(0), "float32")
    with pytest.raises(DonorAxisError):
        Server(tb, ServeConfig(batch_slots=1, max_len=16, policy="kv_peer_hbm"),
               params, device="cpu")
    server = Server(tb, ServeConfig(batch_slots=1, max_len=16), params,
                    device="cpu")
    server.submit(np.arange(1, 4), max_new_tokens=8)
    with pytest.raises(ServeHangError, match="max_steps=2"):
        server.run_until_done(max_steps=2)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    tb = ModelBundle(smoke_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tb.init_cache(1, 8)


@pytest.mark.parametrize("temp", [1e-3, 0.5, 1.0, 2.5])
@pytest.mark.parametrize("top_k", [0, 1, 3, 17, 64, 1000])
@pytest.mark.parametrize("top_p", [1e-6, 0.3, 0.9, 1.0])
def test_filter_matches_reference_oracle(temp, top_k, top_p):
    B, V = 4, 64
    rng = np.random.default_rng(top_k * 1000 + int(temp * 10))
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3.0
    t = np.full(B, temp, np.float32)
    k = np.full(B, top_k, np.int32)
    p = np.full(B, top_p, np.float32)
    got = filter_logits(torch.from_numpy(logits), torch.from_numpy(t),
                        torch.from_numpy(k), torch.from_numpy(p)).numpy()
    want = jax_filter_logits_ref(logits, t, k, p)
    np.testing.assert_array_equal(want, filter_logits_ref(logits, t, k, p))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=2e-5, atol=2e-5)


def _sampled_run(tb, params, batch_mates):
    server = Server(tb, ServeConfig(batch_slots=3, max_len=64,
                                    prefill_chunk=4), params, device="cpu")
    req = server.submit(np.arange(1, 8), max_new_tokens=8, rid=0,
                        sampling=SamplingParams(temperature=0.9, top_k=50,
                                                seed=1234))
    for i, n in enumerate(batch_mates):
        server.submit(np.arange(2, 2 + n), max_new_tokens=4, rid=1 + i)
    server.run_until_done(max_steps=200)
    return req.out_tokens


def test_sampled_request_is_seed_and_position_deterministic():
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(3))
    a = _sampled_run(tb, params, [])
    b = _sampled_run(tb, params, [5, 9])
    assert a == b and len(a) == 8
    greedy = Server(tb, ServeConfig(batch_slots=1, max_len=64), params,
                    device="cpu")
    g = greedy.submit(np.arange(1, 8), max_new_tokens=8)
    greedy.run_until_done()
    assert g.out_tokens != a      # temperature 0.9 actually samples


def test_idle_state_has_the_slot_table_schema():
    from repro_torch.serve.state import DeviceState, SlotTable

    idle = DeviceState(3, "cpu")
    live = DeviceState(3, "cpu")
    live.load(SlotTable(3))
    assert idle.buffers.keys() == live.buffers.keys() == SlotTable(3).mirrors().keys()
    for k in idle.buffers:
        assert (idle[k].shape, idle[k].dtype) == (live[k].shape, live[k].dtype), k
        assert torch.equal(idle[k], live[k]), k


def test_sample_tokens_greedy_rows_and_uniforms():
    logits = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    state = {
        "temp": torch.tensor([0.0, 1.0, 0.0, 1.0]),
        "top_k": torch.zeros(4, dtype=torch.int32),
        "top_p": torch.ones(4),
        "seed": torch.tensor([0, 5, 0, 5]),
        "lengths": torch.tensor([3, 3, 3, 4], dtype=torch.int32),
    }
    tok = sample_tokens(logits, state)
    greedy = torch.argmax(logits, -1).to(torch.int32)
    assert tok[0] == greedy[0] and tok[2] == greedy[2]
    u = uniforms(state["seed"], state["lengths"], 32)
    assert bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u[1], uniforms(torch.tensor([5]),
                                      torch.tensor([3]), 32)[0])
    assert not torch.equal(u[1], u[3])      # another position, other bits
