"""The port's preemption and scheduler surface, held to the reference.

The load-bearing invariant, as in the reference: greedy tokens are the
same under any scheduling history.  So the port's ``Server`` with
planner-priced preemption, oversubscribed, gives per rid the greedy
tokens the reference ``Server`` (``mesh=None``) gives on the same weights,
with at least one spill and every spill promoted back; the counts may
differ from the reference's, since the step-price EWMA is wall time.

Also mirrored from the reference's tests: the thrash guard, ``preempt``
off, the runtime's spill price, the spill record and the slot table's
suspend/resume, cancel and deadlines, ``run_until_done``'s
:class:`ServeHangError`, the asyncio ``Scheduler`` (submit, stream,
backpressure, close, ``step_timeout_s``) and the ``stats()`` keys.
Sampled requests are held to the port's own unpreempted run (the
sampled bits differ from the reference's by design).
"""

import asyncio
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro.serve.state import SlotTable as JaxSlotTable
from repro.serve.state import SpilledSequence as JaxSpilledSequence
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core.hardware import MemoryTier
from repro_torch.core.placement import Placement
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.serve import (
    QueueFullError,
    Request,
    SamplingParams,
    Scheduler,
    SchedulerClosed,
    ServeConfig,
    ServeHangError,
    Server,
    SlotTable,
    SpilledSequence,
)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module", params=["olmo-1b", "yi-6b"])
def pair(request):
    arch = request.param
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


@pytest.fixture(scope="module")
def olmo():
    tb = ModelBundle(dataclasses.replace(smoke_config("olmo-1b"), dtype="float32"))
    return tb, tb.init_params(torch.Generator().manual_seed(0))


def _prompts(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, 4 + 3 * i).astype(np.int32) for i in range(n)]


def _cfg(**kw):
    return {"batch_slots": 2, "max_len": 48, "prefill_chunk": 4, **kw}


def _port(tb, tparams, **kw):
    return Server(tb, ServeConfig(**_cfg(**kw)), tparams, device="cpu")


def _serve(server, prompts, new=lambda i: 6 + 2 * i, req_cls=Request, **rkw):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=new(i), **rkw)
            for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


def test_preempted_tokens_match_the_reference(pair):
    jb, jparams, tb, tparams = pair
    prompts = _prompts(jb.cfg.vocab)
    want = _serve(JaxServer(jb, JaxServeConfig(**_cfg(preempt=True, preempt_wait=2)),
                            jparams), prompts, req_cls=JaxRequest)
    server = _port(tb, tparams, preempt=True, preempt_wait=2)
    got = _serve(server, prompts)
    st = server.stats()
    assert got == want
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    assert st["spill_s"] > 0 and st["restore_s"] > 0
    assert st["spilled"] == 0 and st["queued"] == 0
    # the same again with spill verification on
    server = _port(tb, tparams, preempt=True, preempt_wait=2, verify_spills=True)
    assert _serve(server, prompts) == want
    assert server.stats()["spill_corruptions"] == 0


def test_sampled_requests_survive_preemption(olmo):
    tb, params = olmo
    prompts = _prompts(tb.cfg.vocab, n=5)

    def run(**kw):
        server = _port(tb, params, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8 + 2 * i,
                        sampling=SamplingParams(temperature=0.8, top_k=12, seed=i))
                for i, p in enumerate(prompts)]
        server.add_requests(reqs)
        server.run_until_done(2000)
        return [r.out_tokens for r in reqs], server.stats()

    base, _ = run()
    got, st = run(preempt=True, preempt_wait=2)
    assert st["preemptions"] >= 1 and got == base


def test_no_preemption_when_disabled(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1)
    _serve(server, _prompts(tb.cfg.vocab, n=3), new=lambda i: 10)
    assert server.stats()["preemptions"] == 0


def test_thrash_guard_respects_preempt_wait(olmo):
    tb, params = olmo
    server = Server(tb, ServeConfig(batch_slots=1, max_len=32, preempt=True,
                                    preempt_wait=64), params, device="cpu")
    _serve(server, _prompts(tb.cfg.vocab, n=3), new=lambda i: 4)
    assert server.stats()["preemptions"] == 0


def test_runtime_prices_the_spill(olmo):
    tb, params = olmo
    server = _port(tb, params)
    nbytes = server.engine.slot_bytes()
    B = server.cfg.batch_slots
    assert nbytes == sum(t.numel() * t.element_size() for t in
                         tree_leaves(server.engine.caches)) // B > 0
    place, price = server.runtime.preemption_price(nbytes)
    # no far tier on the CPU: rows park in the device's own memory
    assert place.tier is MemoryTier.HBM
    assert price == (server.runtime.price_copy(nbytes, place)
                     + server.runtime.price_copy(nbytes, "hbm", src=place)) >= 0.0
    assert server.runtime.decode_step_seconds(B, server.cfg.max_len) > 0.0


def test_slot_extract_insert_round_trip(olmo):
    tb, params = olmo
    for policy in ("hbm_resident", "kv_host"):
        server = _port(tb, params, policy=policy)
        server.submit(np.arange(1, 9), max_new_tokens=12)
        for _ in range(3):
            server.step()
        eng = server.engine
        before = [t[:, 0:1].clone() for t in tree_leaves(eng.caches)]
        rows = eng.extract_slot(0, Placement(MemoryTier.HOST))
        assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(rows)))
        eng.insert_slot(1, rows)
        for a, t in zip(before, tree_leaves(eng.caches)):
            assert torch.equal(t[:, 1:2], a) and torch.equal(t[:, 0:1], a)
        assert eng._spill_pool == [rows]
        # rows parked in the device's memory are freed on promotion
        dev = eng.extract_slot(0, Placement(MemoryTier.HBM))
        assert dev is not rows
        eng.insert_slot(1, dev)
        assert eng._spill_pool == [rows]


def test_suspend_and_resume_mirror_the_reference():
    """The slot table's spill record and resumed mirrors are the
    reference's, field for field."""
    sp = SamplingParams(temperature=0.5, top_k=7, top_p=0.9, seed=11, stop_tokens=(3, 9))
    from repro.serve.sampling import SamplingParams as JaxSP

    jsp = JaxSP(temperature=0.5, top_k=7, top_p=0.9, seed=11, stop_tokens=(3, 9))
    port, ref = SlotTable(3), JaxSlotTable(3)
    for t, s in ((port, sp), (ref, jsp)):
        t.claim(1, 42, s, tick=5)
        t.lengths[1] = 17
        t.last_tokens[1, 0] = 8
        t.active[1] = True
    assert port.occupancy(32) == ref.occupancy(32)
    a, b = port.suspend(1, tick=9), ref.suspend(1, tick=9)
    for f in dataclasses.fields(JaxSpilledSequence):
        if f.name != "sampling":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert dataclasses.asdict(a.sampling) == dataclasses.asdict(b.sampling)
    assert [f.name for f in dataclasses.fields(SpilledSequence)] == [
        f.name for f in dataclasses.fields(JaxSpilledSequence)]
    port.resume(2, a, tick=12)
    ref.resume(2, b, tick=12)
    for name in ("lengths", "last_tokens", "active", "temp", "top_k", "top_p", "stop",
                 "claimed_tick"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), name)
    np.testing.assert_array_equal(port.seed.astype(np.int64), ref.seed.astype(np.int64))
    assert port.slots == ref.slots == [None, None, 42]


def test_cancel_mid_generation_frees_slot(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1)
    seen = []
    req = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=20,
                  on_token=lambda r, t: seen.append(t))
    server.add_request(req)
    server.step()
    server.step()
    n = len(req.out_tokens)
    assert n >= 1 and not req.done
    req.cancel()
    server.step()
    assert req.done and req.finished_s is not None
    assert len(req.out_tokens) == n and seen[-1] == -1
    assert server.stats()["cancelled"] == 1 and not server.has_work()


def test_cancel_queued_and_spilled_requests(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1, preempt=True, preempt_wait=2)
    reqs = [server.submit(np.arange(1, 6 + i), max_new_tokens=30) for i in range(3)]
    while not server.stats()["spilled"]:
        server.step()
    spilled = next(r for r in reqs if r.rid in server._spilled)
    queued = next(r for r in reqs if not r.out_tokens)
    spilled.cancel()
    queued.cancel()
    server.step()
    assert spilled.done and queued.done and server.stats()["cancelled"] == 2
    assert server.stats()["spilled"] == 0
    server.run_until_done(500)
    assert all(r.done for r in reqs)


def test_deadline_expires_queued_request(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1)
    seen = []
    req = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=4,
                  deadline_s=0.0, on_token=lambda r, t: seen.append(t))
    server.add_request(req)
    time.sleep(0.01)
    server.step()
    assert req.done and req.out_tokens == [] and seen == [-1]
    assert server.stats()["expired"] == 1 and not server.has_work()


def test_unbounded_requests_unaffected(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1)
    req = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    server.add_request(req)
    server.run_until_done(200)
    assert req.done and len(req.out_tokens) == 4
    assert server.stats()["cancelled"] == server.stats()["expired"] == 0


def test_exhausted_steps_raise_serve_hang_error(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1)
    server.add_request(Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                               max_new_tokens=25))
    with pytest.raises(ServeHangError) as ei:
        server.run_until_done(max_steps=2)
    assert ei.value.live_rids == (0,)
    assert "max_steps=2" in str(ei.value) and "decode_tokens" in ei.value.stats
    server.run_until_done(200)                    # still drainable after
    server.run_until_done(max_steps=1)            # no work: no raise


def test_stats_keys_are_the_references(pair):
    """Every key of the reference's ``stats()``, the decode-step replay
    admission's ``decode_replay_prefills`` included."""
    jb, jparams, tb, tparams = pair
    jserver = JaxServer(jb, JaxServeConfig(batch_slots=1, max_len=32), jparams)
    server = _port(tb, tparams, batch_slots=1, max_len=32)
    for s, cls in ((jserver, JaxRequest), (server, Request)):
        s.add_request(cls(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=6))
        s.run_until_done(100)
    want = set(jserver.stats())
    got = server.stats()
    assert want <= set(got), want - set(got)
    assert got["decode_tokens"] == jserver.stats()["decode_tokens"] == 6
    assert server.throughput()["decode_tps"] > 0


def _solo(tb, params, prompt, n):
    server = _port(tb, params, batch_slots=1)
    req = server.submit(prompt, max_new_tokens=n)
    server.run_until_done(200)
    return req.out_tokens


def test_async_submit_stream_drain(olmo):
    tb, params = olmo
    server = _port(tb, params, max_queue=2)
    sched = Scheduler(server)
    prompts = [np.arange(1, 6 + i, dtype=np.int32) for i in range(5)]

    async def client(i):
        req = await sched.submit(prompts[i], max_new_tokens=4)
        return [tok async for tok in sched.stream(req)]

    async def main():
        async def clients():
            outs = await asyncio.gather(*(client(i) for i in range(5)))
            sched.close()
            return outs
        _, outs = await asyncio.gather(sched.run(), clients())
        return outs

    outs = asyncio.run(main())
    assert all(len(o) == 4 for o in outs) and not server.has_work()
    for prompt, out in zip(prompts, outs):
        assert out == _solo(tb, params, prompt, 4)


def test_async_backpressure_never_raises_through_submit(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1, max_queue=1)
    sched = Scheduler(server)

    async def main():
        async def client(i):
            req = await sched.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=2)
            async for _ in sched.stream(req):
                pass
            return req

        async def clients():
            reqs = await asyncio.gather(*(client(i) for i in range(4)))
            sched.close()
            return reqs
        _, reqs = await asyncio.gather(sched.run(), clients())
        return reqs

    reqs = asyncio.run(main())
    assert all(r.done for r in reqs) and server.stats()["peak_queue"] <= 1
    with pytest.raises(QueueFullError):
        server.add_request(Request(rid=9, prompt=np.arange(1, 4), max_new_tokens=1))
        server.add_request(Request(rid=10, prompt=np.arange(1, 4), max_new_tokens=1))


def test_async_close_cancels_pending_submit(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1, max_queue=1)
    sched = Scheduler(server)

    async def main():
        await sched.submit(np.arange(1, 6), max_new_tokens=8)
        blocked = asyncio.ensure_future(sched.submit(np.arange(1, 6), max_new_tokens=4))
        await asyncio.sleep(0)
        assert not blocked.done()
        sched.close()
        with pytest.raises(SchedulerClosed):
            await blocked
        await sched.run()                 # drains what was admitted

    asyncio.run(main())
    assert not server.has_work()


def test_async_close_after_submit_raises_and_timeout_is_configurable(olmo):
    tb, params = olmo
    server = _port(tb, params, batch_slots=1)
    sched = Scheduler(server)

    async def main():
        sched.close()
        with pytest.raises(SchedulerClosed):
            await sched.submit(np.arange(1, 6), max_new_tokens=4)

    asyncio.run(main())
    assert sched.step_timeout_s == 60.0
    assert Scheduler(server, step_timeout_s=None).step_timeout_s is None


def test_async_step_timeout_raises_serve_hang_error(olmo):
    """A step that outlives ``step_timeout_s`` surfaces as ServeHangError
    with the server's diagnostics."""
    from repro_torch.core.faults import FaultEvent, FaultKind, FaultPlan

    tb, params = olmo
    plan = FaultPlan([FaultEvent("decode", 0, FaultKind.STALL, seconds=0.3)])
    server = _port(tb, params, batch_slots=1, faults=plan)
    sched = Scheduler(server, step_timeout_s=0.05)

    async def main():
        await sched.submit(np.arange(1, 6), max_new_tokens=2)
        await sched.run()

    with pytest.raises(ServeHangError) as ei:
        asyncio.run(main())
    assert "off-thread bound" in str(ei.value) and ei.value.live_rids == (0,)
