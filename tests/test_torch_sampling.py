"""The port's Green kernels (``math/green.py``) and sampling operators
(``ops/sampling.py``: ``Pooling``, ``NNSampling``,
``GeneralisedVandermonde``, ``MappedDistanceMatrix``) against the JAX
package on the CPU, on the same numpy inputs: apply, adjoint, ``todense``,
the adjoint identity, and ``examples/rbf_interpolation.py``'s ``main()``
problem after 30 ``APGD`` iterations.

Tolerances: rtol 1e-5 / atol 1e-6 for the kernels and the gathers;
rtol 1e-4 / atol 1e-5 for products and segment sums (``index_add`` against
``segment_sum``, matrix products summed in another order), and for the
adjoint identity; the solver's iterates within 1e-4 x max(1, max |x|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.math.green as jgreen
import pycsou_tpu.ops.sampling as jsamp
import pycsou_tpu.opt as jopt
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.math.green as tgreen
import pycsou_tpu_torch.ops.sampling as tsamp
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.utils.device import set_default_device

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def check_op(top, jop, rng, tol=LOOSE):
    """Shapes, apply, adjoint and ``todense`` against JAX; the port's
    adjoint identity ``<A x, y> = <x, A^H y>``."""
    assert top.dim_shape == tuple(jop.dim_shape) and top.codim_shape == tuple(jop.codim_shape)
    x, y = _rand(rng, top.dim_shape), _rand(rng, top.codim_shape)
    ax, ahy = top.apply(torch.from_numpy(x)), top.adjoint(torch.from_numpy(y))
    np.testing.assert_allclose(ax.numpy(), np.asarray(jop.apply(jnp.asarray(x))), **tol)
    np.testing.assert_allclose(ahy.numpy(), np.asarray(jop.adjoint(jnp.asarray(y))), **tol)
    lhs, rhs = float(torch.vdot(torch.from_numpy(y).reshape(-1), ax.reshape(-1))), float(
        torch.vdot(ahy.reshape(-1), torch.from_numpy(x).reshape(-1)))
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))
    np.testing.assert_allclose(top.todense().mat.numpy(), np.asarray(jop.todense().mat), **tol)
    assert top.batchable


# -- math/green.py -----------------------------------------------------------


GREEN = [("Matern", dict(k=k, epsilon=0.3)) for k in range(4)] + [
    ("Wendland", dict(k=k, epsilon=0.7)) for k in range(4)] + [
    ("CausalGreenIteratedDerivative", dict(k=1)), ("CausalGreenIteratedDerivative", dict(k=3)),
    ("CausalGreenExponential", dict(k=1, alpha=0.5)), ("CausalGreenExponential", dict(k=2, alpha=2.0)),
    ("SubGaussian", dict(alpha=1.0, epsilon=0.5)), ("SubGaussian", dict(alpha=2.0, epsilon=2.0)),
    ("SubGaussian", dict(alpha=0.5, epsilon=1.0))]


@pytest.mark.parametrize("name,kw", GREEN, ids=[f"{n}-{'-'.join(map(str, k.values()))}" for n, k in GREEN])
def test_green_matches_jax(rng, name, kw):
    """Each kernel on distances in [0, 1.5] (and signed abscissae for the
    causal ones), as tests/test_ops.py's Matern and Wendland cases."""
    r = np.abs(_rand(rng, 40)) * 0.75
    if name.startswith("Causal"):
        r = r - 0.5
    gt, gj = getattr(tgreen, name)(**kw), getattr(jgreen, name)(**kw)
    np.testing.assert_allclose(gt(torch.from_numpy(r)).numpy(), np.asarray(gj(jnp.asarray(r))), **TIGHT)


def test_green_supports_and_bad_orders():
    assert tgreen.Matern(2, 0.1).support() == jgreen.Matern(2, 0.1).support() == pytest.approx(0.3)
    assert tgreen.Matern(2, 0.1).support(5) == jgreen.Matern(2, 0.1).support(5)
    assert tgreen.Wendland(1, 0.2).support == jgreen.Wendland(1, 0.2).support == 0.2
    for cls in ("Matern", "Wendland"):
        with pytest.raises(ValueError):
            getattr(tgreen, cls)(k=4)
    with pytest.raises(ValueError):
        tgreen.SubGaussian(alpha=2.5)


# -- ops/sampling.py ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["sum", "mean"])
@pytest.mark.parametrize("shape,block", [((8, 6), (2, 3)), ((7, 10), (3, 4)), ((9,), 4), ((5, 6, 7), (2, 3, 2))])
def test_pooling(rng, kind, shape, block):
    """Dividing blocks (tests/test_ops.py::test_pooling) and blocks that pad
    the trailing edge (test_pooling_pads_non_dividing_blocks)."""
    top, jop = tsamp.Pooling(shape, block, kind=kind), jsamp.Pooling(shape, block, kind=kind)
    assert top.lipschitz == pytest.approx(jop.lipschitz, rel=1e-12)
    check_op(top, jop, rng, TIGHT)


def test_pooling_bad_arguments():
    with pytest.raises(ValueError, match="kind"):
        tsamp.Pooling((4, 4), 2, kind="max")
    with pytest.raises(ValueError, match="rank"):
        tsamp.Pooling((4, 4), (2, 2, 2))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_nn_sampling_1d(rng, mode):
    """tests/test_ops.py::test_nn_sampling as parity: 15 samples on a
    20-node line, both adjoint modes."""
    grid = np.linspace(0, 1, 20)
    samples = rng.uniform(0, 1, 15)
    top, jop = tsamp.NNSampling(grid, samples, adjoint_mode=mode), jsamp.NNSampling(grid, samples, adjoint_mode=mode)
    np.testing.assert_array_equal(top.indices.numpy(), np.asarray(jop.indices))
    np.testing.assert_array_equal(top.counts.numpy(), np.asarray(jop.counts))
    if mode == "sum":
        check_op(top, jop, rng, TIGHT)
    else:
        y = _rand(rng, 15)
        np.testing.assert_allclose(top.adjoint(torch.from_numpy(y)).numpy(), np.asarray(jop.adjoint(jnp.asarray(y))),
                                   **LOOSE)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_nn_sampling_2d_grid(rng, mode):
    """Off-grid samples on a 2-D grid, the domain shaped as the grid."""
    g = np.linspace(0, 1, 12)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    samples = rng.uniform(0, 1, (300, 2))
    top = tsamp.NNSampling(grid, samples, dim_shape=(12, 12), adjoint_mode=mode)
    jop = jsamp.NNSampling(grid, samples, dim_shape=(12, 12), adjoint_mode=mode)
    x, y = _rand(rng, (12, 12)), _rand(rng, 300)
    np.testing.assert_array_equal(top.apply(torch.from_numpy(x)).numpy(), np.asarray(jop.apply(jnp.asarray(x))))
    np.testing.assert_allclose(top.adjoint(torch.from_numpy(y)).numpy(), np.asarray(jop.adjoint(jnp.asarray(y))),
                               **LOOSE)
    with pytest.raises(ValueError, match="adjoint_mode"):
        tsamp.NNSampling(grid, samples, adjoint_mode="max")


def test_vandermonde(rng):
    """tests/test_ops.py::test_vandermonde as parity, and monomials up to
    degree 7 at 200 samples."""
    z = np.linspace(0, 1, 11)
    fs = [lambda t: t**0, lambda t: t, lambda t: t**2]
    top, jop = tsamp.GeneralisedVandermonde(fs, z), jsamp.GeneralisedVandermonde(fs, z)
    np.testing.assert_allclose(top.apply(torch.tensor([1.0, 2.0, 3.0])).numpy(), 1 + 2 * z + 3 * z**2, rtol=1e-5)
    check_op(top, jop, rng)
    z = rng.uniform(-1, 1, 200)
    fs = [lambda t, k=k: t**k for k in range(8)]
    check_op(tsamp.GeneralisedVandermonde(fs, z), jsamp.GeneralisedVandermonde(fs, z), rng)


@pytest.mark.parametrize("backend", ["dense", "matrix-free", "sparse"])
@pytest.mark.parametrize("mode", ["radial", "zonal"])
def test_mapped_distance_matrix(rng, backend, mode):
    """Every backend in both modes (tests/test_ops.py's dense and
    matrix-free Matern case, the sparse Wendland case; the zonal sparse
    operator raises in both packages)."""
    s1, s2 = rng.uniform(0, 1, (37, 2)).astype(np.float32), rng.uniform(0, 1, (29, 2)).astype(np.float32)
    if mode == "zonal":
        s1 /= np.linalg.norm(s1, axis=1, keepdims=True)
        s2 /= np.linalg.norm(s2, axis=1, keepdims=True)
    kw = dict(mode=mode, backend=backend, block=8)
    ft, fj = (tgreen.Wendland(1, 0.4), jgreen.Wendland(1, 0.4)) if backend == "sparse" else (
        tgreen.Matern(1, 0.3), jgreen.Matern(1, 0.3))
    if backend == "sparse" and mode == "zonal":
        for mod, f in ((tsamp, ft), (jsamp, fj)):
            with pytest.raises(ValueError, match="radial"):
                mod.MappedDistanceMatrix(s1, s2, f, **kw)
        return
    top, jop = tsamp.MappedDistanceMatrix(s1, s2, ft, **kw), jsamp.MappedDistanceMatrix(s1, s2, fj, **kw)
    if backend == "sparse":
        np.testing.assert_array_equal(top._nbr_idx.numpy(), np.asarray(jop._nbr_idx))
        np.testing.assert_allclose(top._nbr_val.numpy(), np.asarray(jop._nbr_val), **TIGHT)
        assert top._nbr_idx.shape[1] < 29
    check_op(top, jop, rng)


def test_mdm_sparse_equals_dense(rng):
    """tests/test_ops.py::test_mdm_sparse_backend_equals_dense in the port:
    the sparse backend against the dense one on a Wendland kernel."""
    s1, s2 = rng.uniform(size=(120, 2)).astype(np.float32), rng.uniform(size=(90, 2)).astype(np.float32)
    f = tgreen.Wendland(k=1, epsilon=0.2)
    dense = tsamp.MappedDistanceMatrix(s1, s2, f, backend="dense")
    sparse = tsamp.MappedDistanceMatrix(s1, s2, f, backend="sparse")
    mf = tsamp.MappedDistanceMatrix(s1, s2, f, backend="matrix-free", block=32)
    assert sparse._nbr_idx.shape[1] < 60
    x, y = torch.from_numpy(_rand(rng, 90)), torch.from_numpy(_rand(rng, 120))
    for op in (sparse, mf):
        np.testing.assert_allclose(op.apply(x).numpy(), dense.apply(x).numpy(), **LOOSE)
        np.testing.assert_allclose(op.adjoint(y).numpy(), dense.adjoint(y).numpy(), **LOOSE)


def test_mdm_sparse_requires_support(rng):
    """tests/test_ops.py::test_mdm_sparse_requires_support, and a bad mode
    or backend."""
    s = rng.uniform(size=(10, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="support"):
        tsamp.MappedDistanceMatrix(s, s, lambda d: torch.exp(-d), backend="sparse")
    op = tsamp.MappedDistanceMatrix(s, s, lambda d: torch.clamp(1 - d / 0.3, min=0.0), backend="sparse", support=0.3)
    jop = jsamp.MappedDistanceMatrix(s, s, lambda d: jnp.maximum(1 - d / 0.3, 0.0), backend="sparse", support=0.3)
    x = _rand(rng, 10)
    np.testing.assert_allclose(op.apply(torch.from_numpy(x)).numpy(), np.asarray(jop.apply(jnp.asarray(x))), **LOOSE)
    for kw in (dict(mode="geodesic"), dict(backend="dask")):
        with pytest.raises(ValueError):
            tsamp.MappedDistanceMatrix(s, s, tgreen.Matern(), **kw)


def test_rbf_interpolation_main_matches_jax():
    """``examples/rbf_interpolation.py``'s ``main()`` problem (120 samples,
    60 centres, ``Matern(k=2, epsilon=0.08)``, ridge 0.05): the power
    iteration's norm and 30 ``APGD`` iterations against the JAX package."""
    rng = np.random.default_rng(0)
    t_obs = np.sort(rng.uniform(0, 1, 120)).astype(np.float32)
    y = (np.sin(6 * np.pi * t_obs) * np.exp(-t_obs) + 0.05 * rng.standard_normal(120)).astype(np.float32)
    centers = np.linspace(0, 1, 60).astype(np.float32)
    Kt = tsamp.MappedDistanceMatrix(t_obs, centers, tgreen.Matern(k=2, epsilon=0.08))
    Kj = jsamp.MappedDistanceMatrix(t_obs, centers, jgreen.Matern(k=2, epsilon=0.08))
    Kt.lipschitz = Kj.lipschitz = float(np.linalg.norm(np.asarray(Kj._mat), 2))
    st = topt.APGD((60,), F=tfunc.SquaredL2Loss((120,), data=y) * Kt, G=0.05 * tfunc.SquaredL2Norm((60,)))
    sj = jopt.APGD((60,), F=jfunc.SquaredL2Loss((120,), data=jnp.asarray(y)) * Kj,
                   G=0.05 * jfunc.SquaredL2Norm((60,)))
    ts, js = st.run_fixed(30), sj.run_fixed(30)
    for k in ("x", "x_temp"):
        want = np.asarray(js[k])
        np.testing.assert_allclose(ts[k].numpy(), want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))
