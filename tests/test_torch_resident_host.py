"""RESIDENT host placements (``kv=host``, ``params=host``, ``opt=host``,
``master=host``), on the CPU.

A RESIDENT host placement keeps a role in host memory and the steps
compute on it in place: on a card through CUDA tensors over the card's
mapped view of a pinned arena (``tests/test_torch_cuda.py`` holds the
kernels there), on the CPU in a plain host arena of its own, so the
serving and training paths run whole here.  Held here, on float32 smoke
configs:

* greedy tokens of yi-6b-smoke and olmo-1b-smoke under ``kv=host``,
  ``params=host``, both, and ``kv=host`` with streamed weights equal the
  port's ``hbm_resident`` tokens and the reference ``Server``'s (under
  ``hbm_resident`` and under the same policy with ``mesh=None``, where the
  reference's placement is a no-op: ROADMAP C3); the final host caches are
  allclose to ``hbm_resident``'s at 1e-6, and a RESIDENT role is never
  streamed (no window, no write-back);
* 3 AdamW steps of olmo-1b-smoke and mamba2-smoke under ``opt=host`` and
  ``master=host``: loss, grad norm, params and optimizer state bit for bit
  equal to ``hbm_resident``'s, the placed state in a host arena, and the
  reference's run within ``tests/test_torch_train.py``'s tolerances.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.placement import Role
from repro_torch.models.sharding import tree_leaves, tree_map

from test_torch_placed_serve import _pair, _prompts, _ref_tokens, _serve
from test_torch_placed_train import _equal, _run
from test_torch_train import _bundles, _jax_train

RESIDENT = ["kv=host", "params=host", "kv=host,params=host", "kv=host,params=host:stream"]


@functools.lru_cache(maxsize=None)
def _served(arch):
    """The pair of bundles and weights, the prompts, the reference's
    ``hbm_resident`` tokens and the port's ``hbm_resident`` server."""
    jb, jparams, tb, tparams = _pair(arch)
    prompts = _prompts(jb.cfg.vocab)
    server, got = _serve(tb, tparams, "hbm_resident", prompts)
    want = _ref_tokens(jb, jparams, prompts)
    assert got == want
    return jb, jparams, tb, tparams, prompts, want, server


@pytest.mark.parametrize("policy", RESIDENT)
@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b"])
def test_resident_host_serving_equals_hbm_resident_and_the_reference(arch, policy):
    jb, jparams, tb, tparams, prompts, want, resident = _served(arch)
    server, got = _serve(tb, tparams, policy, prompts)
    assert got == want
    assert _ref_tokens(jb, jparams, prompts, policy) == want
    rt, eng = server.runtime, server.engine
    for role in (Role.KV_CACHE, Role.PARAMS):
        on_host = eng.policy.placement(role).on_host
        tree = eng.caches if role is Role.KV_CACHE else eng.params
        # a host-placed role lives in a host arena of its own
        assert all((getattr(t, "_host_arena", None) is not None) == on_host
                   for t in tree_leaves(tree)), role
    assert not rt.streamed(Role.KV_CACHE)              # kv=host is RESIDENT
    assert rt.streamed(Role.PARAMS) == policy.endswith(":stream")
    assert (eng.feed is None) == (not rt.streamed(Role.PARAMS))
    if eng.feed is not None:
        assert set(eng.feed.streams()) == {"params"}
    for a, b in zip(tree_leaves(resident.engine.caches), tree_leaves(eng.caches)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _trained(arch, steps=3, lr=1e-3, warmup=2):
    (jparams, jopt, _), ref_steps = _jax_train(arch, steps, lr, warmup)
    _, tb = _bundles(arch)
    start = convert.params_from_jax((jparams, jopt), "cpu")
    return tb, start, ref_steps, _run(tb, start, None, steps, lr, warmup)


@pytest.mark.parametrize("policy", ["opt=host", "master=host"])
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m"])
def test_resident_host_training_equals_hbm_resident_and_the_reference(arch, policy):
    lr, warmup, steps = 1e-3, 2, 3
    tb, start, ref_steps, (resident, r_opt) = _trained(arch)
    placed, p_opt = _run(tb, start, policy, steps, lr, warmup)
    for (rl, rg, rp), (pl, pg, pp) in zip(resident, placed):
        assert torch.equal(rl, pl) and torch.equal(rg, pg)
        assert _equal(rp, pp)
    roles = {"master": "master" in policy, "mu": "opt" in policy, "nu": "opt" in policy}
    for k, on_host in roles.items():
        assert _equal(r_opt[k], p_opt[k])
        assert all((getattr(t, "_host_arena", None) is not None) == on_host
                   for t in tree_leaves(p_opt[k])), k
    assert int(p_opt["step"]) == steps
    lr_sum = 0.0
    for i, ((jloss, jgnorm, jp), (pl, pg, pp)) in enumerate(zip(ref_steps, placed)):
        lr_sum += lr * min((i + 1) / warmup, 1.0)
        np.testing.assert_allclose(float(pl), jloss, rtol=1e-5 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(pg), jgnorm, rtol=1e-4)
        diffs = []
        tree_map(lambda g, w: diffs.append(np.abs(g.numpy() - w).ravel()), pp, jp)
        diffs = np.concatenate(diffs)
        assert diffs.max() <= 2 * lr_sum * 1.1, (i, diffs.max())
        assert np.quantile(diffs, 0.99) <= 1e-5, (i, np.quantile(diffs, 0.99))
