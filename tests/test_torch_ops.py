"""The port's operator and functional algebra (pycsou_tpu_torch.core, ops,
func, math) against the JAX package, on the CPU.

Same numpy inputs into both packages; tolerances rtol 1e-5 / atol 1e-6
for f32 elementwise code, rtol 3e-4 / atol 3e-5 where a convolution is
summed in another order (XLA banded matmuls vs F.conv2d).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.ops.conv as jconv
import pycsou_tpu.ops.diff as jdiff
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops.conv as tconv
import pycsou_tpu_torch.ops.diff as tdiff
from pycsou_tpu_torch.core.functional import DiffProxFuncPreComp, ProxFuncPostComp
from pycsou_tpu_torch.ops.basic import HomothetyOperator, IdentityOperator, NullOperator
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


S = (24, 40)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _gauss(k=7, s=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _rank2(k=7):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h = np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))
    return (h / h.sum()).astype(np.float32)


PSFS = {
    "gauss": _gauss(),
    "rank2": _rank2(),
    "even": _rank2(6)[:, 1:],
    "fullrank": np.random.default_rng(3).random((5, 5)).astype(np.float32),
}


def _dot_test(op, rng, rtol=1e-4):
    x = _t(rng.standard_normal(op.dim_shape))
    y = _t(rng.standard_normal(op.codim_shape))
    lhs = torch.sum(y * op.apply(x)).item()
    rhs = torch.sum(op.adjoint(y) * x).item()
    np.testing.assert_allclose(lhs, rhs, rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("name", list(PSFS))
def test_convolve2d_matches_jax(rng, name):
    """Apply and adjoint against the JAX Convolve2D; dot test; the
    Lipschitz bound and the factor taps are the reference's, bit for bit.
    The 5 x 5 full-rank PSF takes 'direct' (25 taps <= 81), the
    reference's pick on its CPU backend."""
    h = PSFS[name]
    A = tconv.Convolve2D(S, h)
    J = jconv.Convolve2D(S, jnp.asarray(h))
    assert A.method == J.method == ("direct" if name == "fullrank" else "band")
    assert A.lipschitz == J.lipschitz
    x = rng.standard_normal(S).astype(np.float32)
    _close(A.apply(_t(x)), J.apply(jnp.asarray(x)), rtol=3e-4, atol=3e-5)
    _close(A.adjoint(_t(x)), J.adjoint(jnp.asarray(x)), rtol=3e-4, atol=3e-5)
    _dot_test(A, rng)
    if name != "fullrank":
        ju, jv = jconv.lowrank_factors(np.asarray(J.filt))
        np.testing.assert_array_equal(A.factors[0], ju)
        np.testing.assert_array_equal(A.factors[1], jv)


@pytest.mark.parametrize("name", ["gauss", "rank2"])
def test_separable_gram_matches_jax(rng, name):
    h = PSFS[name]
    A = tconv.Convolve2D(S, h)
    J = jconv.Convolve2D(S, jnp.asarray(h))
    G, JG = A.gram, J.gram
    assert type(G) is tconv.SeparableConvGram2D
    assert G.lipschitz == JG.lipschitz
    x = rng.standard_normal(S).astype(np.float32)
    atb = rng.standard_normal(S).astype(np.float32)
    want = JG.apply(jnp.asarray(x))
    _close(G.apply(_t(x)), want, rtol=3e-4, atol=3e-5)
    _close(G.grad_fused(_t(x), _t(atb)), 2.0 * (want - jnp.asarray(atb)), rtol=3e-4, atol=3e-5)


def test_convolve2d_unported_methods_raise():
    """Every method is ported; what still raises is a method the PSF does
    not fit: 'band' for a full-rank PSF, 'bandg' for a rank-1 one (and for
    a rank-6 PSF over 31 taps), and an unknown method."""
    with pytest.raises(ValueError, match="rank"):
        tconv.Convolve2D(S, PSFS["fullrank"], method="band")
    with pytest.raises(ValueError, match="bandg"):
        tconv.Convolve2D(S, _gauss(), method="bandg")
    wide = np.random.default_rng(1).standard_normal((33, 6)) @ np.random.default_rng(2).standard_normal((6, 5))
    with pytest.raises(ValueError, match="bandg"):
        tconv.Convolve2D((48, 40), wide, method="bandg")
    with pytest.raises(ValueError, match="method must be"):
        tconv.Convolve2D(S, _gauss(), method="xla")


def test_gradient_matches_jax(rng):
    K = tdiff.Gradient(S)
    JK = jdiff.Gradient(S)
    assert K.lipschitz == JK.lipschitz == np.sqrt(8.0)
    x = rng.standard_normal(S).astype(np.float32)
    z = rng.standard_normal((2,) + S).astype(np.float32)
    _close(K.apply(_t(x)), JK.apply(jnp.asarray(x)))
    _close(K.adjoint(_t(z)), JK.adjoint(jnp.asarray(z)))
    _dot_test(K, rng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdiff.Gradient(S, kind="centered")


@pytest.mark.parametrize("axis", [0, 1])
def test_fdiff_matches_jax(rng, axis):
    x = rng.standard_normal(S).astype(np.float32)
    _close(tdiff.fdiff_forward(_t(x), axis), jdiff.fdiff_forward(jnp.asarray(x), axis))
    _close(tdiff.fdiff_forward_adjoint(_t(x), axis), jdiff.fdiff_forward_adjoint(jnp.asarray(x), axis))


def test_arithmetic_builds_the_reference_nodes(rng):
    """SquaredL2Loss * A composes to LeastSquaresLoss (gradient through the
    fused Gram), lam * L21Norm to a scaled prox node, and the shifted
    SquaredL2Norm stays differentiable (_PLAIN_TO_DIFF)."""
    h = _gauss()
    y = rng.standard_normal(S).astype(np.float32)
    loss = tfunc.SquaredL2Loss(S, data=y)
    assert type(loss) is DiffProxFuncPreComp
    F = loss * tconv.Convolve2D(S, h)
    JF = jfunc.SquaredL2Loss(S, data=jnp.asarray(y)) * jconv.Convolve2D(S, jnp.asarray(h))
    assert type(F) is tfunc.LeastSquaresLoss and type(JF).__name__ == "LeastSquaresLoss"
    assert F.diff_lipschitz == JF.diff_lipschitz
    x = rng.standard_normal(S).astype(np.float32)
    _close(F.gradient(_t(x)), JF.gradient(jnp.asarray(x)), rtol=3e-4, atol=3e-5)
    _close(F.apply(_t(x)), JF.apply(jnp.asarray(x)), rtol=1e-4)
    H = 0.05 * tfunc.L21Norm((2,) + S, axis=0)
    assert type(H) is ProxFuncPostComp and H.scale == 0.05
    # scalar arithmetic on operators: homothety nodes with the Lipschitz rules
    B = 3.0 * IdentityOperator(S)
    assert B.lipschitz == 3.0
    _close(B.apply(_t(x)), 3.0 * x)
    assert isinstance(2.0 * HomothetyOperator(1.5, S), tconv.LinearOperator)
    _close(NullOperator(S).adjoint(_t(x)), np.zeros(S))


@pytest.mark.parametrize("iso", [True, False])
def test_tv_proxes_match_jax(rng, iso):
    """The dual prox the generic PDS chain takes: prox and fenchel_prox of
    lam * L21Norm (isotropic) and lam * L1Norm (anisotropic)."""
    z = rng.standard_normal((2,) + S).astype(np.float32)
    if iso:
        H, JH = 0.3 * tfunc.L21Norm((2,) + S, axis=0), 0.3 * jpen.L21Norm((2,) + S, axis=0)
    else:
        H, JH = 0.3 * tfunc.L1Norm((2,) + S), 0.3 * jpen.L1Norm((2,) + S)
    _close(H.prox(_t(z), 0.7), JH.prox(jnp.asarray(z), 0.7))
    _close(H.fenchel_prox(_t(z), 0.7), JH.fenchel_prox(jnp.asarray(z), 0.7))
    _close(H.apply(_t(z)), JH.apply(jnp.asarray(z)), rtol=1e-5, atol=1e-4)
    G, JG = tfunc.NonNegativeOrthant(S), jfunc.NonNegativeOrthant(S)
    _close(G.prox(_t(z[0]), 1.0), JG.prox(jnp.asarray(z[0]), 1.0))


def test_default_adjoint_is_the_vjp(rng):
    """A LinearOperator without a closed-form adjoint takes the VJP of its
    apply (the fft Convolve2D): equal to the band operator's K1 adjoint."""
    h = _gauss()
    fft = tconv.Convolve2D(S, h, method="fft")
    band = tconv.Convolve2D(S, h, method="band")
    y = _t(rng.standard_normal(S))
    _close(fft.adjoint(y), band.adjoint(y), rtol=3e-4, atol=3e-5)
    _close(fft.gram.apply(y), band.gram.apply(y), rtol=3e-4, atol=3e-5)
