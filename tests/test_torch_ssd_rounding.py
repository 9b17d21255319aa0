"""Why the bf16 SSD scan kernel feeds every f32 operand as a hi + lo pair.

``csrc/ssd_scan.cu`` runs its products on bf16 tensor cores.  B, C and x
are bf16 already, but three operands are f32: the state h in C·hᵀ, the
decay matrix M = (C·Bᵀ) ∘ L ∘ dt, and x·dt·decay in the state update.  The
kernel splits each into a bf16 hi and a bf16 lo part (two products).  This
file emulates the kernel's chunk-32 arithmetic in PyTorch on the CPU, with
each operand rounded as the kernel does or once to bf16, and holds it to
``ref.ssd_scan`` under the card checks' limits (``chip_smoke.py``: y at
bf16 TOL, the state at 1e-4 x its max): the split passes, and a single
rounding of h breaks y while one of x·dt·decay breaks the state.  (M
rounded once stays inside TOL at this size; at the card's full 8a shape
it put single elements of y past it.)

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_rounding.py
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

Q = 32    # the kernel's chunk


def _inputs(B=2, T=128, H=8, P=64, N=128, seed=0):
    """chip_smoke.py phase 8a's distributions, at a CPU-sized shape."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = (r(B, T, H, P) * 0.5).bfloat16()
    dt = F.softplus(r(B, T, H) - 1.0) * 0.5
    A = -torch.exp(r(H) * 0.5)
    Bm, Cm = (r(B, T, N) * 0.5).bfloat16(), (r(B, T, N) * 0.5).bfloat16()
    return x, dt, A, Bm, Cm, r(B, H, P, N)


def _as_operand(t, split):
    """An f32 operand as the tensor cores see it: a bf16 hi + lo pair, or
    one bf16 rounding."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float() if split else hi


def _emulate(x, dt, A, Bm, Cm, h0, split_h=True, split_m=True, split_xw=True):
    """The bf16 kernel's arithmetic: products of bf16 operands summed in
    f32, chunk by chunk, the state carried in f32."""
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    h, ys = h0.clone(), []
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]
    for c0 in range(0, x.shape[1], Q):
        xc, dc, bc, cc = xf[:, c0:c0 + Q], dt[:, c0:c0 + Q], Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        cum = torch.cumsum(A * dc, 1)                                   # (B, Q, H)
        G = torch.einsum("bin,bjn->bij", cc, bc)
        delta = torch.where(tri, cum[:, :, None] - cum[:, None], 0.0)
        M = torch.where(tri, G[..., None] * torch.exp(delta) * dc[:, None], 0.0)
        y = torch.einsum("bijh,bjhp->bihp", _as_operand(M, split_m), xc)
        y += torch.einsum("bin,bhpn->bihp", cc, _as_operand(h, split_h)) * torch.exp(cum)[..., None]
        ys.append(y)
        w = torch.exp(cum[:, -1:] - cum) * dc                            # (B, Q, H)
        xw = _as_operand(xc * w[..., None], split_xw)
        h = h * torch.exp(cum[:, -1])[..., None, None] + torch.einsum("bjhp,bjn->bhpn", xw, bc)
    return torch.cat(ys, 1).bfloat16(), h


def _y_elements_out(y, want):
    """Elements of y outside chip_smoke.py's bf16 TOL (atol 1e-2, rtol 1e-2)."""
    err = (y.float() - want.float()).abs()
    return int((err > 1e-2 + 1e-2 * want.float().abs()).sum())


def _state_err(h, want):
    """The state's max error over chip_smoke.py's limit, 1e-4 x max |want|."""
    return float((h - want).abs().max()) / (1e-4 * float(want.abs().max()))


@pytest.fixture(scope="module")
def case():
    x, dt, A, Bm, Cm, h0 = _inputs()
    want = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=64, init_state=h0, return_state=True)
    return (x, dt, A, Bm, Cm, h0), want


def test_the_kernels_split_meets_both_limits(case):
    args, (want_y, want_h) = case
    y, h = _emulate(*args)
    assert _y_elements_out(y, want_y) == 0
    assert _state_err(h, want_h) < 0.1


def test_one_rounding_of_the_state_breaks_y(case):
    args, (want_y, want_h) = case
    y, h = _emulate(*args, split_h=False)
    assert _y_elements_out(y, want_y) > 0
    assert _state_err(h, want_h) < 0.1          # the state itself is untouched


def test_one_rounding_of_the_update_breaks_the_state(case):
    args, (want_y, want_h) = case
    _, h = _emulate(*args, split_xw=False)
    assert _state_err(h, want_h) > 1.0


def test_the_split_keeps_a_zero_dt_row_bit_for_bit():
    """dt = 0: every decay is exp(0) = 1 and every added term 0."""
    x, dt, A, Bm, Cm, h0 = _inputs(B=1, T=64, H=2)
    _, h = _emulate(x, torch.zeros_like(dt), A, Bm, Cm, h0)
    assert torch.equal(h, h0)
