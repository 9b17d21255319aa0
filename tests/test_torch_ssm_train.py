"""The port's Mamba-2 training path vs the JAX reference, on the CPU.

* ``ref.ssd_scan_bwd`` (the plain version the backward kernel is held
  against) against ``jax.vjp`` of the reference's ``ops.ssd_scan`` with
  ``backend="pallas"``: its Pallas kernel in interpret mode under its
  ``custom_vjp``;
* with an initial state and a final-state gradient, against ``jax.vjp`` of
  the reference's plain scan (the only path that carries a state), both
  through ``ref.ssd_scan_bwd`` and through ``ops.ssd_scan``'s autograd
  Function on the CPU;
* one Mamba-2 block's ``ssm_train``, its output and the gradients of its
  params and input, against the reference's.

Inputs are numpy arrays from a seed, fed to both packages.  Tolerance:
tests/test_kernels.py:96's f32 limit, atol = rtol = 2e-4, the atol scaled
by each leaf's largest |value| (gradients of dt and A sum over every
position and head, and reach 1e1-1e2 where an absolute limit means
nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm
from repro_torch.models.sharding import materialize

jax.config.update("jax_platform_name", "cpu")

REL = 2e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, name=""):
    w = np.asarray(want, np.float32)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=REL,
                               atol=REL * scale, err_msg=name)


def _inputs(B, T, H, P, N, seed, state=False):
    """x, dt (softplus), A (negative), B, C, dy, and with ``state`` an
    initial state and a final-state gradient."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x = f(B, T, H, P) * 0.5
    dt = (np.log1p(np.exp(f(B, T, H))) * 0.1).astype(np.float32)
    A = (-np.exp(f(H) * 0.5)).astype(np.float32)
    Bm, Cm, dy = f(B, T, N) * 0.5, f(B, T, N) * 0.5, f(B, T, H, P)
    h0, dh = (f(B, H, P, N), f(B, H, P, N)) if state else (None, None)
    return x, dt, A, Bm, Cm, dy, h0, dh


@pytest.mark.parametrize("P,N,B,H", [(32, 16, 2, 3), (64, 128, 1, 2)])
@pytest.mark.parametrize("T,chunk", [(16, 16), (64, 16), (64, 32), (96, 32)])
def test_plain_backward_matches_reference_pallas_vjp(T, chunk, P, N, B, H):
    """The smoke widths (P 32, N 16) and mamba2-780m's (P 64, N 128), one
    chunk and several."""
    x, dt, A, Bm, Cm, dy, _, _ = _inputs(B, T, H, P, N, seed=T + chunk + P)
    _, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=chunk, backend="pallas"),
                     *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_scan_bwd(*(_t(a) for a in (x, dt, A, Bm, Cm)), _t(dy), chunk=chunk)
    assert got[5] is None
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def _reference_state_vjp(x, dt, A, Bm, Cm, dy, h0, dh, chunk):
    def f(*a):
        return jref.ssd_scan(*a[:5], chunk=chunk, init_state=a[5], return_state=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)))
    return vjp((jnp.asarray(dy), jnp.asarray(dh if dh is not None else np.zeros_like(h0))))


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("T,chunk", [(64, 16), (96, 32)])
def test_plain_backward_carries_the_state(T, chunk, with_dh):
    """The initial state's gradient, and the final state's gradient seeding
    the backward, against the reference's plain scan."""
    x, dt, A, Bm, Cm, dy, h0, dh = _inputs(2, T, 3, 32, 16, seed=T, state=True)
    dh = dh if with_dh else None
    want = _reference_state_vjp(x, dt, A, Bm, Cm, dy, h0, dh, chunk)
    got = ref.ssd_scan_bwd(*(_t(a) for a in (x, dt, A, Bm, Cm)), _t(dy), chunk=chunk,
                           init_state=_t(h0),
                           d_state_out=None if dh is None else _t(dh))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("return_state", [False, True])
def test_ops_function_gradients_match_reference(return_state):
    """``ops.ssd_scan``'s autograd Function on the CPU (plain forward and
    ``ref.ssd_scan_bwd``): y's and the final state's gradients reach every
    input and the initial state as in the reference."""
    T, chunk = 64, 16
    x, dt, A, Bm, Cm, dy, h0, dh = _inputs(2, T, 3, 32, 16, seed=11, state=True)
    want = _reference_state_vjp(x, dt, A, Bm, Cm, dy, h0,
                                dh if return_state else None, chunk)
    ins = [_t(a).requires_grad_() for a in (x, dt, A, Bm, Cm, h0)]
    out = ops.ssd_scan(*ins[:5], chunk=chunk, init_state=ins[5], return_state=return_state)
    if return_state:
        y, h = out
        loss = (y * _t(dy)).sum() + (h * _t(dh)).sum()
    else:
        loss = (out * _t(dy)).sum()
    got = torch.autograd.grad(loss, ins)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def _block(arch, seed):
    cfg = jax_smoke_config(arch)
    d, spec = cfg.d_model, cfg.ssm
    params = materialize(tssm.ssm_defs(d, spec), torch.Generator().manual_seed(seed),
                         "float32")
    # nonzero a_log / dt_bias / conv_b, d_skip off 1: every term is exercised
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias", "conv_b", "d_skip"):
        params[k] = _t((rng.normal(size=params[k].shape) * 0.5).astype(np.float32))
    return d, spec, params


@pytest.mark.parametrize("S", [16, 64])
def test_ssm_train_matches_reference(S):
    """Output and the gradients of every param and of the input, at the
    smoke widths (zamba2-smoke's SSM layers have mamba2-smoke's)."""
    d, spec, params = _block("mamba2-780m", seed=S)
    rng = np.random.default_rng(S + 1)
    x = (rng.normal(size=(2, S, d)) * 0.5).astype(np.float32)
    gy = rng.normal(size=(2, S, d)).astype(np.float32)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want, vjp = jax.vjp(lambda p, xx: jssm.ssm_train(p, xx, d, spec),
                        jparams, jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(gy))
    tparams = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx = _t(x).requires_grad_()
    got = tssm.ssm_train(tparams, tx, d, spec)
    _close(got, want, "y")
    grads = torch.autograd.grad(got, [tx, *tparams.values()], _t(gy))
    _close(grads[0], want_gx, "dx")
    for (k, _), g in zip(tparams.items(), grads[1:]):
        _close(g, want_gp[k], k)
