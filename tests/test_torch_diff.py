"""The port's finite-difference operators (``pycsou_tpu_torch/ops/diff.py``)
against the JAX package on the CPU: apply, adjoint and ``lipschitz`` on the
same numpy inputs, and the port's adjoint identity ``<A x, y> = <x, A^H
y>``.

Tolerances: rtol 1e-5 / atol 1e-5 for the stencils (f32, the same
differences; the generalised operators chain up to four of them), rtol
1e-4 for the adjoint identity's two f32 sums, ``lipschitz`` equal to 1e-6
relative (the same closed forms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.ops.diff as jdiff
import pycsou_tpu_torch.ops.diff as tdiff
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


S = (24, 20)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def check_op(top, jop, rng, rtol=1e-5, atol=1e-5):
    """apply, adjoint, lipschitz against JAX; the port's adjoint identity."""
    assert top.dim_shape == tuple(jop.dim_shape) and top.codim_shape == tuple(jop.codim_shape)
    x = rng.standard_normal(top.dim_shape).astype(np.float32)
    y = rng.standard_normal(top.codim_shape).astype(np.float32)
    ax = top.apply(_t(x))
    np.testing.assert_allclose(ax.numpy(), np.asarray(jop.apply(jnp.asarray(x))), rtol=rtol, atol=atol)
    ahy = top.adjoint(_t(y))
    np.testing.assert_allclose(ahy.numpy(), np.asarray(jop.adjoint(jnp.asarray(y))), rtol=rtol, atol=atol)
    lhs, rhs = float(torch.sum(ax * _t(y))), float(torch.sum(_t(x) * ahy))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(top.lipschitz, jop.lipschitz, rtol=1e-6)


@pytest.mark.parametrize("kind", ["forward", "backward", "centered"])
@pytest.mark.parametrize("axis", [0, 1])
def test_first_derivative_matches_jax(rng, kind, axis):
    check_op(tdiff.FirstDerivative(S, axis=axis, kind=kind, step=0.5),
             jdiff.FirstDerivative(S, axis=axis, kind=kind, step=0.5), rng)


@pytest.mark.parametrize("axis", [0, 1])
def test_second_derivative_matches_jax(rng, axis):
    check_op(tdiff.SecondDerivative(S, axis=axis, step=2.0), jdiff.SecondDerivative(S, axis=axis, step=2.0), rng)


@pytest.mark.parametrize("kind,kw", [
    ("iterated", dict(order=2)),
    ("sobolev", dict(order=2, alpha=1.5)),
    ("exponential", dict(order=3, alpha=0.5)),
    ("polynomial", dict(coeffs=[1.0, -0.5, 0.25])),
    ("iterated", dict(order=1, kill_edges=False)),
])
def test_generalised_derivative_matches_jax(rng, kind, kw):
    """The operator algebra's compositions and the edge kill."""
    check_op(tdiff.GeneralisedDerivative(S, axis=1, kind=kind, **kw),
             jdiff.GeneralisedDerivative(S, axis=1, kind=kind, **kw), rng)


@pytest.mark.parametrize("kind", ["forward", "backward", "centered"])
def test_gradient_kinds_match_jax(rng, kind):
    """The centered kind's Lipschitz is 1/step an axis."""
    K = tdiff.Gradient(S, kind=kind, step=(1.0, 0.5))
    check_op(K, jdiff.Gradient(S, kind=kind, step=(1.0, 0.5)), rng)
    per_axis = (1.0 if kind == "centered" else 2.0) * np.array([1.0, 2.0])
    assert K.lipschitz == pytest.approx(float(np.sqrt(np.sum(per_axis**2))), rel=1e-12)


@pytest.mark.parametrize("axes", [None, (1,)])
def test_laplacian_matches_jax(rng, axes):
    check_op(tdiff.Laplacian(S, axes=axes, step=0.5), jdiff.Laplacian(S, axes=axes, step=0.5), rng)


@pytest.mark.parametrize("kind,kw", [
    ("iterated", dict(order=2)),
    ("sobolev", dict(order=1, alpha=2.0)),
    ("polynomial", dict(coeffs=[0.5, 1.0])),
])
def test_generalised_laplacian_matches_jax(rng, kind, kw):
    check_op(tdiff.GeneralisedLaplacian(S, kind=kind, **kw), jdiff.GeneralisedLaplacian(S, kind=kind, **kw), rng)


def _field(rng):
    return rng.standard_normal((2,) + S).astype(np.float32)


@pytest.mark.parametrize("constant", [True, False])
def test_directional_derivatives_match_jax(rng, constant):
    """A constant direction and a spatially varying field."""
    v = np.array([0.6, -0.8], np.float32) if constant else _field(rng)
    check_op(tdiff.FirstDirectionalDerivative(S, v, step=0.5), jdiff.FirstDirectionalDerivative(S, jnp.asarray(v), step=0.5), rng)
    check_op(tdiff.SecondDirectionalDerivative(S, v), jdiff.SecondDirectionalDerivative(S, jnp.asarray(v)), rng,
             rtol=1e-4, atol=1e-4)


def test_directional_gradient_and_laplacian_match_jax(rng):
    vs = [np.array([1.0, 0.0], np.float32), _field(rng)]
    check_op(tdiff.DirectionalGradient(S, vs), jdiff.DirectionalGradient(S, [jnp.asarray(v) for v in vs]), rng)
    check_op(tdiff.DirectionalLaplacian(S, vs, weights=[0.5, 2.0]),
             jdiff.DirectionalLaplacian(S, [jnp.asarray(v) for v in vs], weights=[0.5, 2.0]), rng,
             rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("axis", [0, 1])
def test_integration_matches_jax(rng, axis):
    check_op(tdiff.Integration1D(S, axis=axis, step=0.1), jdiff.Integration1D(S, axis=axis, step=0.1), rng)


@pytest.mark.parametrize("fn", ["fdiff_backward", "fdiff_centered", "sdiff"])
@pytest.mark.parametrize("axis", [0, 1])
def test_stencils_match_jax(rng, fn, axis):
    x = rng.standard_normal(S).astype(np.float32)
    np.testing.assert_allclose(getattr(tdiff, fn)(_t(x), axis, 0.5).numpy(),
                               np.asarray(getattr(jdiff, fn)(jnp.asarray(x), axis, 0.5)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tdiff.sdiff_adjoint(_t(x), axis, 0.5).numpy(),
                               np.asarray(jdiff.sdiff_adjoint(jnp.asarray(x), axis, 0.5)), rtol=1e-6, atol=1e-6)


def test_kind_validation():
    with pytest.raises(ValueError, match="kind"):
        tdiff.Gradient(S, kind="upwind")
    with pytest.raises(ValueError, match="kind"):
        tdiff.FirstDerivative(S, kind="upwind")
    with pytest.raises(ValueError, match="coeffs"):
        tdiff.GeneralisedDerivative(S, kind="polynomial")
