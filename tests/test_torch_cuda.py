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
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_prefill,
)
from repro_torch.kernels.ssd_scan import ssd_scan
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


def _live_rows(kind, kw, Sq, Sk, q_offset):
    qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    if kind == "bidirectional":
        return torch.ones(Sq, dtype=torch.bool, device="cuda")
    live = qp >= kp
    if kind == "sliding":
        live &= (qp - kp) < kw["window"]
    elif kind == "chunked":
        live &= (qp // kw["chunk"]) == (kp // kw["chunk"])
    return live.any(-1)


#: gradients: f32 sums over up to Sk terms in another order; bf16 grads
#: are rounded once more than the plain version's f32 ones
GRAD_TOL = {torch.bfloat16: dict(atol=3e-2, rtol=3e-2),
            torch.float32: dict(atol=1e-4, rtol=1e-4)}


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,q_offset,kind,kw", [
    (2, 4, 4, 128, 128, 128, 0, "causal", {}),
    (1, 8, 2, 100, 100, 64, 0, "causal", {}),
    (2, 8, 1, 77, 77, 16, 0, "causal", {}),
    (1, 4, 2, 96, 160, 32, 64, "sliding", {"window": 40}),
    (1, 4, 2, 96, 160, 32, 64, "chunked", {"chunk": 48}),
    (1, 4, 2, 50, 90, 64, 7, "bidirectional", {}),
])
def test_flash_attention_fwd_bwd_match_plain(B, Hq, Hkv, Sq, Sk, D, q_offset,
                                             kind, kw, dtype):
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
    q = _randn(B, Hq, Sq, D, dtype=dtype, seed=8).requires_grad_()
    k = _randn(B, Hkv, Sk, D, dtype=dtype, seed=9).requires_grad_()
    v = _randn(B, Hkv, Sk, D, dtype=dtype, seed=10).requires_grad_()
    dout = _randn(B, Hq, Sq, D, dtype=dtype, seed=11)
    rows = _live_rows(kind, kw, Sq, Sk, q_offset)
    dout = dout * rows[:, None].to(dtype)      # padding rows carry no gradient
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    got = ops.attention(q, k, v, kind=kind, q_offset=q_offset, **kw)
    g_got = torch.autograd.grad(got, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    want = ref.attention(q, k, v, kind=kind, q_offset=q_offset, **kw)
    g_want = torch.autograd.grad(want, (q, k, v), dout)
    torch.testing.assert_close(got.float()[:, :, rows], want.float()[:, :, rows],
                               **TOL[dtype])
    for a, b in zip(g_got, g_want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **GRAD_TOL[dtype])


@requires_cuda
def test_flash_attention_lse_and_dead_rows():
    """lse is the row log-sum-exp of the scaled scores; a row with no live
    key (sliding window before position 0) comes out 0."""
    q = _randn(1, 2, 40, 32, dtype=torch.float32, seed=12)
    k = _randn(1, 2, 64, 32, dtype=torch.float32, seed=13)
    out, lse = flash_attention(q, k, k, kind="causal")
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 32 ** -0.5
    s = s.masked_fill(torch.arange(40, device="cuda")[:, None]
                      < torch.arange(64, device="cuda")[None, :], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    out, _ = flash_attention(q, k, k, kind="chunked", chunk=16, q_offset=-8)
    torch.cuda.synchronize()
    assert torch.all(out[:, :, :8] == 0)       # positions -8..-1: no live key


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
    x = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        flash_attention(x, x, x, kind="sliding")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x[..., :48].contiguous(), x[..., :48].contiguous(),
                        x[..., :48].contiguous())
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="k_lengths"):
        ops.attention(x, x, x, k_lengths=torch.ones(1, device="cuda"))


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


@requires_cuda
@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2), ("dots", 2)])
def test_train_loss_on_card_matches_cpu(remat, fwd_per_layer):
    """A float32 smoke model's loss and grads on the card (flash-attention
    forward and backward kernels) and on the CPU (plain attention), same
    weights and batch; under remat the forward kernel runs again in the
    backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tb.cfg.vocab, (2, 40)).astype(np.int32))
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(d, copy=True).requires_grad_(), params)
        f0, b0 = flash_attention.launches, flash_attention_bwd.launches
        loss, _ = tb.train_loss(p, {"tokens": toks.to(d), "labels": toks.to(d)},
                                remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if d == "cuda":
            torch.cuda.synchronize()
            L = tb.cfg.n_layers
            assert flash_attention.launches - f0 == fwd_per_layer * L
            assert flash_attention_bwd.launches - b0 == L
        out[d] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5, rtol=1e-5)
    # gradients leaf by leaf at 1e-3 x the leaf's largest |value|: the norm
    # over 0.02-scale embeddings scales f32 rounding by ~1/RMS ~ 50 into the
    # input-embedding rows (the CPU parity tests see the same against the
    # reference), and the card sums in other orders than the CPU
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, w, atol=1e-3 * float(w.abs().max()), rtol=1e-4)


# ---------------------------------------------------------------------------
# the SSD scan kernel and the Mamba-2 path
# ---------------------------------------------------------------------------

def _ssd_inputs(B, T, H, P, N, dtype, seed, state=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    x = (r(B, T, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(r(B, T, H)) * 0.1
    A = -torch.exp(r(H) * 0.5)
    Bm, Cm = (r(B, T, N) * 0.5).to(dtype), (r(B, T, N) * 0.5).to(dtype)
    h0 = r(B, H, P, N) if state else None
    return x, dt, A, Bm, Cm, h0


def _scaled(got, want, rel):
    """|got - want| <= rel x max|want| + rel |want|: the scale-aware bound
    of the reference's fast-path tests, for outputs and f32 states."""
    w = want.float()
    torch.testing.assert_close(got.float(), w, atol=rel * float(w.abs().max()),
                               rtol=rel)


#: y: bf16 rounds the kernel's f32 result once (<= 2^-8 relative) and the
#: plain version rounds the same f32 sums in another order; f32 sums in
#: another order.  The f32 state: 1e-4 x the leaf's max |value|.
SSD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,P,N,state", [
    (2, 256, 6, 64, 128, True),     # mamba2-780m's P, N
    (2, 100, 4, 64, 64, True),      # zamba2-1.2b's P, N, ragged T
    (3, 1, 2, 32, 16, True),        # the smoke P, N, one position
    (2, 257, 3, 32, 32, False),     # one past a chunk, no state
])
def test_ssd_kernel_matches_plain(B, T, H, P, N, state, dtype):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(B, T, H, P, N, dtype, seed=T + N, state=state)
    before = ssd_scan.launches
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=T, init_state=h0,
                                  return_state=True)
    _scaled(y, want_y, SSD_TOL[dtype])
    _scaled(h, want_h, 1e-4)
    seq = ref.ssd_scan_sequential(x, dt, A, Bm, Cm, init_state=h0)
    _scaled(y, seq, SSD_TOL[dtype])


@requires_cuda
def test_ssd_kernel_state_in_place_strided_and_zero_dt_rows():
    """The state written into the init buffer itself; x, B, C as slices of
    one conv output (as the model passes them); a row with dt = 0 keeps its
    state bit for bit, a row with dt = 0 past 40 positions has the state of
    those 40."""
    B, T, H, P, N = 3, 90, 4, 64, 64
    g = torch.Generator(device="cuda").manual_seed(21)
    conv = torch.randn(B, T, H * P + 2 * N, generator=g, device="cuda") * 0.5
    x = conv[..., :H * P].reshape(B, T, H, P)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    assert not x.is_contiguous() and not Bm.is_contiguous()
    _, dt, A, _, _, h0 = _ssd_inputs(B, T, H, P, N, torch.float32, seed=22)
    dt[1] = 0.0
    dt[2, 40:] = 0.0
    want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=T, init_state=h0,
                                  return_state=True)
    buf = h0.clone()
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=buf, return_state=True,
                        state_out=buf)
    torch.cuda.synchronize()
    assert h is buf
    _scaled(y, want_y, 1e-4)
    _scaled(buf, want_h, 1e-4)
    assert torch.equal(buf[1], h0[1])
    _, h40 = ops.ssd_scan(x[2:, :40], dt[2:, :40], A, Bm[2:, :40], Cm[2:, :40],
                          init_state=h0[2:].contiguous(), return_state=True)
    _scaled(buf[2], h40[0], 1e-4)


@requires_cuda
def test_ssd_kernel_refuses_what_it_does_not_take():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(1, 8, 2, 64, 128, torch.bfloat16, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ops.ssd_scan(x.requires_grad_(), dt, A, Bm, Cm)
    x = x.detach()
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(x[..., :48], dt, A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, A, Bm, Cm, init_state=h0.transpose(2, 3), return_state=True)


@requires_cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_model_on_card_matches_cpu(arch):
    """A float32 smoke model: prefill_at chunks then decode steps on the
    card and on the CPU, same weights — same greedy tokens, close logits,
    the caches at 1e-4 x each leaf's scale; one scan launch per M layer
    per dispatch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tb = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = tb.init_params(torch.Generator().manual_seed(0))
    p = {"cpu": params, "cuda": tree_map(lambda t: t.cuda(), params)}
    caches = {d: tb.init_cache(3, 32, device=d) for d in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tb.cfg.vocab, (3, 6)).astype(np.int32)
    nl = np.asarray([6, 3, 0], np.int32)
    n_m = tb.cfg.layer_codes().count("M")
    out = {}
    for d in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.array(a)).to(d)  # noqa: E731
        before = ssd_scan.launches
        lg, _ = tb.prefill_at(p[d], {"tokens": t(toks), "new_lens": t(nl)},
                              caches[d], t(np.zeros(3, np.int32)))
        seq = [lg[:2]]
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        for s in range(3):
            lg, _ = tb.decode_step(p[d], {"tokens": tok, "lengths": t(nl + s)},
                                   caches[d])
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            seq.append(lg)
        if d == "cuda":
            torch.cuda.synchronize()
            assert ssd_scan.launches - before == n_m
        out[d] = [x.cpu() for x in seq]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    for a, b in zip(tree_leaves(caches["cpu"]), tree_leaves(caches["cuda"])):
        _scaled(b.cpu(), a, 1e-4)
