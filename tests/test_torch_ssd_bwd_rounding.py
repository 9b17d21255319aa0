"""Which operands of the bf16 SSD backward kernel may take one bf16 rounding.

``csrc/ssd_scan_bwd.cu`` runs every product of its bf16 route on bf16
tensor cores, in chunks of ``BWD_CHUNK`` = 64 positions.  x, dy, B and C
are bf16 already; every other operand is f32 and goes in either as a bf16
hi + lo pair (two products, ~2^-17 relative) or rounded once to bf16:

* ``xw``  x_j · exp(cum_end - cum_j) dt_j, the state pass's forward update;
* ``dye`` dy_k · exp(cum_k), its backward update (the end-state gradient);
* ``S``   the chunk start states h_s, stored in scratch for the chunk pass;
* ``G``   the chunk end-state gradients G_e, likewise;
* ``M``   (C·Bᵀ) ∘ L, in g_j B_j = Σ_k M_kj dy_k + ...;
* ``W``   (dY Xᵀ) ∘ L, in dB's Wᵀ·C;
* ``Wdt`` W_ij dt_j, in dC's W·diag(dt)·B.

This file emulates the kernel's chunk arithmetic in PyTorch on the CPU,
with each operand rounded as the kernel rounds it or as a pair, and holds
the result to ``ref.ssd_scan_bwd`` under ``chip_smoke.py`` phase 8f's bf16
limit: |got - want| <= 5e-2 x max |want| + 5e-2 |want| for each leaf
(``SSD_GRAD_TOL``).  No single rounding, and not all of them together,
comes near that limit (the worst leaf reaches ~5 % of it): bf16 outputs
are rounded once at the end anyway.  The kernel (``KERNEL_SINGLE``)
rounds the scratch states and the three decay-weighted tiles once, which
halves the scratch bytes and the chunk pass's products with them, and
keeps x·w and dy·e as pairs, so the carried state and d_init stay f32.
Which gradient a single rounding moves is shown against phase 8f's f32
limit (2e-4) on the f32 leaves, ddt, dA and d_init (the bf16 leaves' own
final rounding is past that limit already): the scratch state S moves ddt
and dA, dy·e ddt and d_init, G_e and M ddt; x·w, W and W·dt none.

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_bwd_rounding.py
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import BWD_CHUNK

Q = BWD_CHUNK
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init")
OPERANDS = ("xw", "dye", "S", "G", "M", "W", "Wdt")
#: the operands csrc/ssd_scan_bwd.cu rounds once (the rest go in as hi + lo
#: pairs): the scratch states and the three decay-weighted tiles
KERNEL_SINGLE = frozenset({"S", "G", "M", "W", "Wdt"})
#: chip_smoke.py phase 8f's bf16 and f32 limits (SSD_GRAD_TOL)
LIMIT_8F, LIMIT_F32 = 5e-2, 2e-4
#: the leaves the kernel returns in float32
F32_LEAVES = ("ddt", "dA", "d_init")


def _inputs(B=2, T=256, H=8, P=64, N=128, seed=0, dtype=torch.bfloat16):
    """chip_smoke.py phase 8f's distributions at a CPU-sized shape, with an
    initial state and a final-state gradient."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = (r(B, T, H, P) * 0.5).to(dtype)
    dt = F.softplus(r(B, T, H) - 1.0) * 0.5
    A = -torch.exp(r(H) * 0.5)
    Bm, Cm = (r(B, T, N) * 0.5).to(dtype), (r(B, T, N) * 0.5).to(dtype)
    dy = r(B, T, H, P).to(dtype)
    return x, dt, A, Bm, Cm, dy, r(B, H, P, N), r(B, H, P, N)


def _op(t, name, single):
    """An f32 operand as the tensor cores see it: rounded once to bf16, or
    a bf16 hi + lo pair."""
    hi = t.bfloat16().float()
    return hi if name in single else hi + (t - hi).bfloat16().float()


def _emulate(x, dt, A, Bm, Cm, dy, h0, dhT, single=KERNEL_SINGLE):
    """The bf16 kernels' arithmetic: the state pass (chunk start states
    and end-state gradients, carried in f32), then per chunk every head's
    gradients from them; products of bf16 operands summed in f32.  Returns
    (dx, ddt, dA, dB, dC, d_init) in the kernel's output dtypes."""
    Bsz, T, H, P = x.shape
    nc = -(-T // Q)
    pad = nc * Q - T
    padt = lambda t: F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))  # noqa: E731
    xf, dyf, Bf, Cf, dtf = padt(x), padt(dy), padt(Bm), padt(Cm), padt(dt)
    chunks = lambda t: t.reshape(Bsz, nc, Q, *t.shape[2:])  # noqa: E731
    xc, yc, bc, cc, dc = map(chunks, (xf, dyf, Bf, Cf, dtf))
    cum = torch.cumsum(A * dc, 2)                                  # (B, nc, Q, H)
    cend = cum[:, :, -1:]
    ecum, dend = torch.exp(cum), torch.exp(cend - cum)

    # -- the state pass ---------------------------------------------------
    h, S = h0.clone(), []
    for c in range(nc):
        S.append(_op(h, "S", single))
        xw = _op(xc[:, c] * (dend[:, c] * dc[:, c])[..., None], "xw", single)
        h = h * torch.exp(cend[:, c, 0])[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", xw, bc[:, c])
    g, G = dhT.clone(), [None] * nc
    for c in reversed(range(nc)):
        G[c] = _op(g, "G", single)
        ye = _op(yc[:, c] * ecum[:, c][..., None], "dye", single)
        g = g * torch.exp(cend[:, c, 0])[..., None, None] + torch.einsum(
            "bkhp,bkn->bhpn", ye, cc[:, c])
    d_init = g

    # -- the chunk pass ---------------------------------------------------
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool), -1)
    outs = {k: [] for k in ("dx", "ddt", "dB", "dC", "dA")}
    for c in range(nc):
        X, Y, Bq, Cq, d = xc[:, c], yc[:, c], bc[:, c], cc[:, c], dc[:, c]
        cu, ec, de = cum[:, c], ecum[:, c], dend[:, c]              # (B, Q, H)
        hs, ge = S[c], G[c]                                         # (B, H, P, N)
        CB = torch.einsum("bkn,bjn->bkj", Cq, Bq)[..., None]          # (B, Q, Q, 1)
        delta = torch.where(tri[..., None], cu[:, :, None] - cu[:, None], 0.0)
        L = torch.where(tri[..., None], torch.exp(delta), 0.0)      # (B, k, j, H)
        W = torch.einsum("bkhp,bjhp->bkjh", Y, X) * L
        M = CB * L
        Wdt = W * d[:, None]
        R = torch.where(strict[..., None], Wdt * CB, 0.0)
        bg = torch.einsum("bjn,bhpn->bjhp", Bq, ge)                  # G_e B_j
        gB = torch.einsum("bkjh,bkhp->bjhp", _op(M, "M", single), Y) + de[..., None] * bg
        outs["dx"].append(d[..., None] * gB)
        direct = (X * gB).sum(-1)                                   # (B, Q, H)
        u = de * (X * bg).sum(-1)
        hy = torch.einsum("bihp,bhpn->bihn", Y, hs)
        dC = (ec[..., None] * hy + torch.einsum("bijh,bjn->bihn", _op(Wdt, "Wdt", single),
                                                Bq)).sum(2)
        w = ec * (hy * Cq[:, :, None]).sum(-1)
        xg = torch.einsum("bihp,bhpn->bihn", X, ge)
        dB = (d[..., None] * (de[..., None] * xg + torch.einsum(
            "bkih,bkn->bihn", _op(W, "W", single), Cq))).sum(2)
        step = R.sum(1) - R.sum(2)                                  # col - row sums
        t1 = torch.cumsum(step, 1) - step                           # exclusive
        v = d * u
        hg = (hs * ge).sum((-1, -2))                                # (B, H)
        da = (t1 + torch.cumsum(v, 1) - v + torch.flip(torch.cumsum(torch.flip(w, [1]), 1), [1])
              + torch.exp(cend[:, c]) * hg[:, None])
        outs["ddt"].append(direct + A * da)
        outs["dA"].append((d * da).sum((0, 1)))
        outs["dB"].append(dB)
        outs["dC"].append(dC)
    cat = lambda k: torch.cat(outs[k], 1)[:, :T]  # noqa: E731
    return (cat("dx").to(x.dtype), cat("ddt"), torch.stack(outs["dA"]).sum(0),
            cat("dB").to(x.dtype), cat("dC").to(x.dtype), d_init)


def _over(got, want, rel):
    """Each leaf's worst |got - want| / (rel x max |want| + rel |want|):
    above 1 is outside phase 8f's form of limit at ``rel``."""
    out = {}
    for n, g, w in zip(NAMES, got, want):
        g, w = g.float(), w.float()
        out[n] = float(((g - w).abs() / (rel * w.abs().max() + rel * w.abs())).max())
    return out


@pytest.fixture(scope="module")
def case():
    args = _inputs()
    x, dt, A, Bm, Cm, dy, h0, dhT = args
    want = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=64, init_state=h0, d_state_out=dhT)
    return args, want


def test_the_emulation_with_every_pair_is_the_plain_backward(case):
    """Every operand as a pair: the f32 leaves meet phase 8f's f32 limit
    (the kernel's chunked algorithm, ddt's telescoped sums included, is
    the gradient)."""
    args, want = case
    over = _over(_emulate(*args, single=frozenset()), want, LIMIT_F32)
    assert max(over[n] for n in F32_LEAVES) < 0.1, over


def test_the_kernels_roundings_meet_phase_8f(case):
    args, want = case
    over = _over(_emulate(*args), want, LIMIT_8F)
    assert max(over.values()) < 0.2, over                 # 5x inside the limit


@pytest.mark.parametrize("operand", OPERANDS)
def test_one_rounding_alone_stays_inside_phase_8f(case, operand):
    args, want = case
    over = _over(_emulate(*args, single=frozenset({operand})), want, LIMIT_8F)
    assert max(over.values()) < 1.0, over


#: the f32 leaves a single rounding of each operand puts past phase 8f's
#: f32 limit
BREAKS_AT_F32 = {
    "xw": set(),
    "dye": {"ddt", "d_init"},
    "S": {"ddt", "dA"},
    "G": {"ddt"},
    "M": {"ddt"},
    "W": set(),
    "Wdt": set(),
}


@pytest.mark.parametrize("operand", OPERANDS)
def test_which_f32_gradients_one_rounding_breaks(case, operand):
    args, want = case
    over = _over(_emulate(*args, single=frozenset({operand})), want, LIMIT_F32)
    assert {n for n in F32_LEAVES if over[n] >= 1.0} == BREAKS_AT_F32[operand], over


def test_a_zero_dt_position_gets_zero_dx_and_adds_nothing_to_dB():
    """dt = 0 at a position: its dx is 0 and its dB term is 0, exactly."""
    x, dt, A, Bm, Cm, dy, h0, dhT = _inputs(B=1, T=100, H=2)
    dt[0, 30:50] = 0.0
    got = _emulate(x, dt, A, Bm, Cm, dy, h0, dhT)
    assert not got[0][0, 30:50].any()
    assert not got[3][0, 30:50].any()


@pytest.mark.parametrize("T", [1, Q - 1, Q + 1, 257])
def test_ragged_lengths(T):
    """T off the chunk: positions past T are zeros with dt = 0."""
    x, dt, A, Bm, Cm, dy, h0, dhT = _inputs(B=1, T=T, H=2, P=32, N=32, seed=T)
    want = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=T, init_state=h0, d_state_out=dhT)
    over = _over(_emulate(x, dt, A, Bm, Cm, dy, h0, dhT), want, LIMIT_8F)
    assert max(over.values()) < 0.2, over
