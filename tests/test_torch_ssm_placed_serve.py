"""Host placements of Mamba-2 and Zamba-2 serving state, on the CPU.

An ``M`` layer's cache is its recurrent state (the f32 SSM state and the
conv window), which every step rewrites whole; a Zamba-2 ``S`` layer has a
KV cache and reads the model's one shared attention block.  Under
``host:stream`` each layer's state window is staged to the device and
goes back whole after the layer (``HostStream.write_back`` of the ``M``
entries, one copy a leaf), the ``S`` entries' rows through the KV
write-back, and the shared block rides in the weight window of every layer
that applies it; under a RESIDENT host placement the steps compute on the
host copy in place.  Held here, on float32 smoke configs: greedy tokens of
mamba2-smoke and zamba2-smoke under ``kv_host``, ``weights_stream``, both
streamed, ``kv=host`` and ``params=host`` equal the port's
``hbm_resident`` tokens and the reference ``Server``'s (``mesh=None``,
ROADMAP C3), and the final ``ssm``/``conv`` state (and Zamba-2's KV cache)
equals ``hbm_resident``'s bit for bit.
"""

import functools

import pytest
import torch

from repro_torch.core.placement import Role
from repro_torch.models.sharding import tree_leaves

from test_torch_placed_serve import _pair, _prompts, _ref_tokens, _serve

HOST_PLACEMENTS = ["kv_host", "weights_stream", "kv=host:stream,params=host:stream", "kv=host",
            "params=host"]


@functools.lru_cache(maxsize=None)
def _served(arch):
    jb, jparams, tb, tparams = _pair(arch)
    prompts = _prompts(jb.cfg.vocab)
    server, got = _serve(tb, tparams, "hbm_resident", prompts)
    assert got == _ref_tokens(jb, jparams, prompts)
    return jb, jparams, tb, tparams, prompts, got, server


@pytest.mark.parametrize("policy", HOST_PLACEMENTS)
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_state_under_host_placements_equals_hbm_resident(arch, policy):
    jb, jparams, tb, tparams, prompts, want, resident = _served(arch)
    server, got = _serve(tb, tparams, policy, prompts)
    assert got == want
    assert _ref_tokens(jb, jparams, prompts, policy) == want
    eng, rt = server.engine, server.runtime
    codes = tb.cfg.layer_codes()
    # the recurrent state (and zamba2's KV cache), bit for bit
    ref_caches, caches = resident.engine.caches, eng.caches
    for a, b in zip(tree_leaves(ref_caches), tree_leaves(caches)):
        assert torch.equal(a, b)
    for st in ref_caches["stages"]:
        for key, entry in st.items():
            assert set(entry) == ({"ssm", "conv"} if key.endswith("M") else {"k", "v"})
    stream_kv, stream_params = rt.streamed(Role.KV_CACHE), rt.streamed(Role.PARAMS)
    assert stream_kv == (policy in HOST_PLACEMENTS[0:3:2]) and stream_params == (
        policy in HOST_PLACEMENTS[1:3])
    if eng.policy.placement(Role.KV_CACHE).on_host:
        assert all(t._host_arena is not None for t in tree_leaves(caches))
    if stream_params:
        windows = eng.feed.weights.windows
        # the shared block is read once for each S layer that applies it
        assert sum("shared_attn" in w for w in windows) == codes.count("S")
    if stream_kv:
        kv = eng.feed.kv
        assert kv.n_windows == sum(count for _, count, _ in tb.cfg.stages())
        # every window was staged once a step: as many times as the steps
        st = server.stats()
        assert len(kv.fetches) == kv.n_windows * (st["decode_steps"]
                                                  + st["prefill_dispatches"])
