"""The port's CUDA kernels and its card path, held to the plain versions.

These tests need an NVIDIA card and ``nvcc``; without a card each skips
with its reason.  Run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none): the plain PyTorch
versions it compares with are held to the JAX reference on the CPU by
``tests/test_torch_kernels.py`` and ``tests/test_torch_model.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_prefill
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map


@pytest.fixture
def cuda_only():
    """Decides at run time, never at import: skip unless a card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


#: the marker for tests that run only on the card
requires_cuda = pytest.mark.usefixtures("cuda_only")

#: bf16 limits sit near the outputs' scale (row RMS ~ 1/sqrt(live keys),
#: 0.03-0.2 here), well above a one-ulp rounding difference
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
       torch.float32: dict(atol=3e-5, rtol=1e-5)}


def _randn(*shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,Smax,lengths", [
    (3, 8, 1, 16, 64, [1, 17, 64]),
    (2, 16, 16, 128, 300, [299, 1]),
    (2, 32, 4, 128, 1000, [1000, 513]),
])
def test_decode_kernel_matches_plain(B, Hq, Hkv, D, Smax, lengths, dtype):
    q = _randn(B, Hq, D, dtype=dtype, seed=0)
    k = _randn(B, Hkv, Smax, D, dtype=dtype, seed=1)
    v = _randn(B, Hkv, Smax, D, dtype=dtype, seed=2)
    L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    got = ops.decode_attention(q, k, v, L)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, L).float(),
                               **TOL[dtype])


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,kw", [("causal", {}), ("sliding", {"window": 20}),
                                     ("chunked", {"chunk": 24})])
def test_prefill_kernel_matches_plain(kind, kw, dtype):
    B, Hq, Hkv, D, Sc, Sn = 3, 8, 2, 64, 90, 12
    q = _randn(B, Hq, Sn, D, dtype=dtype, seed=3)
    kc, vc = (_randn(B, Hkv, Sc, D, dtype=dtype, seed=s) for s in (4, 5))
    kn, vn = (_randn(B, Hkv, Sn, D, dtype=dtype, seed=s) for s in (6, 7))
    offs = torch.tensor([[0], [40], [78]], dtype=torch.int32, device="cuda")
    nl = torch.tensor([[12], [5], [0]], dtype=torch.int32, device="cuda")
    j = torch.arange(Sn, dtype=torch.int32, device="cuda")[None]
    r = torch.arange(Sc, dtype=torch.int32, device="cuda")[None]
    q_pos = (offs + j).contiguous()
    k_pos = torch.cat([torch.where(r < offs, r, -1),
                       torch.where(j < nl, q_pos, -1)], 1).contiguous()
    before = flash_prefill.launches
    got = ops.prefill_attention(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn,
                                kind=kind, **kw)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = ref.prefill_attention(q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2),
                                 q_pos, k_pos, kind=kind, **kw)
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    live = ((qp >= kp) & (kp >= 0))
    if kind == "sliding":
        live &= (qp - kp) < kw["window"]
    elif kind == "chunked":
        live &= (qp // kw["chunk"]) == (kp // kw["chunk"])
    rows = live.any(-1)[:, None, :].expand(B, Hq, Sn)     # padding rows differ
    torch.testing.assert_close(got.float()[rows], want.float()[rows], **TOL[dtype])


@requires_cuda
def test_kernels_refuse_what_they_do_not_take():
    q = torch.zeros(1, 2, 80, device="cuda", dtype=torch.bfloat16)
    cache = torch.zeros(1, 2, 8, 80, device="cuda", dtype=torch.bfloat16)
    L = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(q, cache, cache, L)
    with pytest.raises(TypeError):
        flash_decode(q[..., :64].half(), cache[..., :64].half(),
                     cache[..., :64].half(), L)
    with pytest.raises(ValueError, match="contiguous"):
        c = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.bfloat16)
        flash_decode(q[..., :64].contiguous(), c.transpose(1, 2), c.transpose(1, 2), L)


@requires_cuda
def test_model_on_card_matches_cpu():
    """A float32 smoke model: prefill_at then decode steps on the card and
    on the CPU, same weights — same greedy tokens, close logits."""
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    gparams = tree_map(lambda t: t.cuda(), params)
    caches = {d: tb.init_cache(2, 32, device=d) for d in ("cpu", "cuda")}
    p = {"cpu": params, "cuda": gparams}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tb.cfg.vocab, (2, 6)).astype(np.int32)
    nl = np.asarray([6, 3], np.int32)
    out = {}
    for d in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.array(a)).to(d)  # noqa: E731
        lg, _ = tb.prefill_at(p[d], {"tokens": t(toks), "new_lens": t(nl)},
                              caches[d], t(np.zeros(2, np.int32)))
        seq = [lg]
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        for s in range(3):
            lg, _ = tb.decode_step(p[d], {"tokens": tok, "lengths": t(nl + s)},
                                   caches[d])
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            seq.append(lg)
        out[d] = [x.cpu() for x in seq]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    for a, b in zip(tree_leaves(caches["cpu"]), tree_leaves(caches["cuda"])):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
