"""Serving under realized host placements, on the CPU.

On the CPU a host placement is realized in plain host memory (host memory
*is* the CPU device's), so the streaming path runs whole: each layer's
weights and cache staged through two slots (``HostStream``), each layer's
new cache rows written back with the plain version of the write-back
kernel.  Held here:

* greedy tokens per request of yi-6b-smoke and granite-8b-smoke in
  float32 under ``hbm_resident``, ``kv_host``, ``weights_stream`` and
  ``kv=host:stream,params=host:stream`` are identical to each other and
  to the reference ``Server``'s, under ``hbm_resident`` and under the same
  policy with ``mesh=None`` (where the reference's placement is a no-op:
  its host-placed run on a one-device mesh fails on this JAX, ROADMAP C3);
* the write-back's plain version against a literal per-row loop
  (hypothesis over positions, counts, ring wrap and rows that write
  nothing);
* every buffer a step reads or writes keeps its address over a run, under
  every placement (the serve graphs' fixed-pointer rule);
* the windows a step streams and the bytes it copies;
* the launcher and ``bench_llm_inference``'s measured leg run the
  placements.

RESIDENT host placements are held in ``tests/test_torch_resident_host.py``,
host placements of ``M``/``S`` models in
``tests/test_torch_ssm_placed_serve.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels import ref
from repro_torch.kernels.kv_stream import kv_write_back
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.serve import Request, ServeConfig, Server

jax.config.update("jax_platform_name", "cpu")

PLACEMENTS = ["hbm_resident", "kv_host", "weights_stream",
            "kv=host:stream,params=host:stream"]


def _pair(arch):
    jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jb, jparams, tb, tparams


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in (9, 14, 3, 6, 1, 11)]


def _serve(tb, params, policy, prompts, *, max_len=40, check=None):
    server = Server(tb, ServeConfig(batch_slots=2, max_len=max_len, prefill_chunk=4,
                                    policy=policy), params, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    steps = 0
    while server.has_work():
        server.step()
        steps += 1
        if check is not None:
            check(server)
    assert steps < 300
    assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
    return server, [r.out_tokens for r in reqs]


def _ref_tokens(jb, jparams, prompts, policy=None, max_len=40):
    server = JaxServer(jb, JaxServeConfig(batch_slots=2, max_len=max_len, prefill_chunk=4,
                                          policy=policy), jparams)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=300)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("arch", ["yi-6b", "granite-8b"])
def test_placed_tokens_equal_each_other_and_the_reference(arch):
    jb, jparams, tb, tparams = _pair(arch)
    prompts = _prompts(jb.cfg.vocab)
    want = _ref_tokens(jb, jparams, prompts)
    for policy in PLACEMENTS:
        server, got = _serve(tb, tparams, policy, prompts)
        assert server.policy.name == server.runtime.policy.name
        assert got == want, policy
    # the reference under the same policies with mesh=None: placement a no-op
    for policy in PLACEMENTS[1:]:
        assert _ref_tokens(jb, jparams, prompts, policy) == want, policy


def _fixed(engine) -> dict[str, int]:
    out = {f"state.{k}": v for k, v in engine.state.buffers.items()}
    out.update({f"prefill.{k}": v for k, v in engine.prefill_in.items()})
    out["out"] = engine.out
    leaves = tree_leaves(engine.caches) + tree_leaves(engine.params)
    if engine.feed is not None:
        leaves += engine.feed.buffers()
    out.update({f"leaf.{i}": t for i, t in enumerate(leaves)})
    return {k: t.data_ptr() for k, t in out.items()}


@pytest.mark.parametrize("policy", PLACEMENTS)
def test_every_buffer_keeps_its_address_under_every_placement(policy):
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    before = [t.clone() for t in tree_leaves(params)]
    seen = {}

    def check(server):
        ptrs = _fixed(server.engine)
        seen.setdefault("ptrs", ptrs)
        assert ptrs == seen["ptrs"], "a buffer moved"

    server, _ = _serve(tb, params, policy, _prompts(tb.cfg.vocab), check=check)
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b)                  # the caller's weights untouched
    for a, b in zip(before, tree_leaves(server.params)):
        assert torch.equal(a, b)                  # nor their placed copy
    st = server.stats()
    assert st["decode_replays"] == st["prefill_replays"] == 0


@pytest.mark.parametrize("policy,streams", [
    ("hbm_resident", {}),
    ("kv_host", {"kv_cache": 2}),
    ("weights_stream", {"params": 4}),
    ("kv=host:stream,params=host:stream", {"kv_cache": 2, "params": 4}),
])
def test_windows_and_bytes_a_step_streams(policy, streams):
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    server = Server(tb, ServeConfig(batch_slots=2, max_len=32, prefill_chunk=4,
                                    policy=policy), params, device="cpu")
    feed = server.engine.feed
    if not streams:
        assert feed is None                       # views of resident trees
        return
    got = {name: s.n_windows for name, s in feed.streams().items()}
    # n_layers windows of cache; the embedding, n_layers layers and the tail
    # (final norm + the tied embedding again) of weights
    assert got == streams and tb.cfg.n_layers == 2
    kv_bytes = sum(t.numel() * 4 for t in tree_leaves(server.engine.caches))
    emb = tb.cfg.vocab * tb.cfg.d_model * 4
    p_bytes = sum(t.numel() * 4 for t in tree_leaves(params)) + emb
    want = (kv_bytes if "kv_cache" in streams else 0) + (
        p_bytes if "params" in streams else 0)
    assert feed.h2d_bytes() == want
    for s in feed.streams().values():
        assert s.slot_bytes >= max(s.window_bytes) and len(s.buffers()) == 2
    server.submit(np.arange(1, 6), max_new_tokens=2)   # one prefill dispatch
    server.step()
    for name, s in feed.streams().items():
        # the prefill dispatch and the first decode step: every window once each
        assert list(s.fetches) == list(range(s.n_windows)) * 2, name


def _loop_write_back(src_k, src_v, dst_k, dst_v, pos, n):
    S = src_k.shape[2]
    for b in range(src_k.shape[0]):
        cnt = int(n[b])
        for p in range(max(cnt - S, 0), cnt):
            slot = (int(pos[b]) + p) % S
            dst_k[b, :, slot] = src_k[b, :, slot]
            dst_v[b, :, slot] = src_v[b, :, slot]


@settings(max_examples=60, deadline=None)
@given(data=st.data(), B=st.integers(1, 4), S=st.integers(1, 12),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_write_back_plain_version_matches_a_literal_loop(data, B, S, dtype):
    pos = data.draw(st.lists(st.integers(0, 3 * S), min_size=B, max_size=B))
    n = data.draw(st.lists(st.integers(0, 2 * S + 1), min_size=B, max_size=B))
    g = torch.Generator().manual_seed(len(pos) * 31 + S)
    src_k, src_v, dst_k, dst_v = (torch.randn(B, 3, S, 4, generator=g).to(dtype)
                                  for _ in range(4))
    want_k, want_v = dst_k.clone(), dst_v.clone()
    _loop_write_back(src_k, src_v, want_k, want_v, pos, n)
    p32, n32 = torch.tensor(pos, dtype=torch.int32), torch.tensor(n, dtype=torch.int32)
    before = kv_write_back.launches
    kv_write_back(src_k, src_v, dst_k, dst_v, p32, n32)   # a CPU source: plain
    assert kv_write_back.launches == before               # no kernel counted
    assert torch.equal(dst_k, want_k) and torch.equal(dst_v, want_v)
    for b in range(B):
        if n[b] == 0:
            assert torch.equal(dst_k[b], want_k[b])


def test_write_back_plain_version_scatters_across_devices_by_rows():
    # src and dst may lie on different devices: only the written rows move
    src = torch.arange(2 * 1 * 5 * 2, dtype=torch.float32).reshape(2, 1, 5, 2)
    dst_k, dst_v = torch.zeros_like(src), torch.zeros_like(src)
    ref.kv_write_back(src, src + 100, dst_k, dst_v, torch.tensor([4, 0], dtype=torch.int32),
                      torch.tensor([2, 0], dtype=torch.int32))
    assert dst_k[0, 0, :, 0].tolist() == [src[0, 0, 0, 0].item(), 0, 0, 0,
                                          src[0, 0, 4, 0].item()]
    assert dst_v[0, 0, 4, 1].item() == src[0, 0, 4, 1].item() + 100
    assert not dst_k[1].any()


def test_auto_on_the_cpu_serves_hbm_resident():
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    server = Server(tb, ServeConfig(batch_slots=2, max_len=16), params, device="cpu")
    assert server.policy.name == "hbm_resident" and server.engine.feed is None
    assert set(server.runtime.plans) == {"serve"}


def test_launcher_serves_under_a_forced_policy():
    from repro_torch.launch import serve as launch_serve

    out = {}
    for policy in ("hbm_resident", "kv_host", "kv=host:stream,params=host:stream"):
        tp = launch_serve.main(["--arch", "yi-6b", "--smoke", "--requests", "3",
                                "--slots", "2", "--max-len", "32", "--prefill-chunk", "4",
                                "--max-new", "3", "--device", "cpu", "--policy", policy])
        out[policy] = tp["decode_tokens"]
    assert set(out.values()) == {9}


def test_measured_leg_tokens_agree_across_placements(capsys):
    from repro_torch.benchmarks import bench_llm_inference

    res = bench_llm_inference.measured(torch.device("cpu"), batch=2, prompt_len=8,
                                       new_tokens=4)
    assert list(res) == list(bench_llm_inference.MEASURED_POLICIES)
    tokens = [r["tokens"] for r in res.values()]
    assert all(t == tokens[0] for t in tokens) and len(tokens[0][0]) == 4
    for name, r in res.items():
        assert r["policy"]["name"] == name and r["device"] == "cpu"
        assert r["decode_steps"] == 4 and r["step_s"] > 0
    rows = [line.split(",")[0] for line in capsys.readouterr().out.splitlines()]
    assert rows == [f"decode[{p}]" for p in bench_llm_inference.MEASURED_POLICIES]
