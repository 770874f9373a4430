"""The port's proximal calculus against the JAX package on the CPU: every
penalty and loss of ``func/``, ``math/prox.py`` and ``utils/misc.py``, on
the same numpy inputs through both packages, with complex data where the
reference takes it; a 64 x 64 Poisson-TV ``PDS`` and a 64 x 64 group
LASSO after 20 iterations.

Tolerances: rtol 1e-5 / atol 1e-6 for elementwise code and small sums;
rtol 1e-4 / atol 1e-5 for the sort-and-cumsum thresholds (the l1-ball
projection, ``SquaredL1Norm``'s ``'sort'`` prox, ``LInftyNorm``), the
fixed loops (Lambert W, the entropy prox, the ``'root'`` bisection) and
the segment sums (``L21Norm``'s groups), where an ulp in a sum or a step
moves the result by more than one rounding; the solvers' iterates within
1e-4 x max(1, max |x|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.loss as jloss
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.math.prox as jprox
import pycsou_tpu.ops as jops
import pycsou_tpu.opt as jopt
import pycsou_tpu.utils.misc as jmisc
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.func.loss as tloss
import pycsou_tpu_torch.func.penalty as tpen
import pycsou_tpu_torch.math.prox as tprox
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
import pycsou_tpu_torch.utils.misc as tmisc
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


def _rand(rng, shape, complex_=False):
    a = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        a = (a + 1j * rng.standard_normal(shape).astype(np.float32)).astype(np.complex64)
    return a


def _both(f_t, f_j, x, tol=TIGHT):
    """``f_t`` on the port's tensor and ``f_j`` on JAX's array of ``x``,
    held to each other."""
    got = f_t(torch.from_numpy(x.copy()))
    want = f_j(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)
    return got


def _close_functional(ft, fj, x, tau, tol=TIGHT, prox_tol=None):
    """Value, prox and ``fenchel_prox`` of two functionals at ``x``."""
    _both(ft.apply, fj.apply, x, tol)
    _both(lambda v: ft.prox(v, tau), lambda v: fj.prox(v, tau), x, prox_tol or tol)
    _both(lambda v: ft.fenchel_prox(v, 1 / tau), lambda v: fj.fenchel_prox(v, 1 / tau), x, prox_tol or tol)


# -- the complex repairs -----------------------------------------------------


def test_squared_l2_loss_fft_complex_data(rng):
    """``SquaredL2Loss(y) * FFTOperator`` with complex data keeps ``y``'s
    imaginary part: the value is real and JAX's, and so is the gradient."""
    y, x = _rand(rng, 8, True), _rand(rng, 8)
    ft = tfunc.SquaredL2Loss((8,), data=y) * tops.FFTOperator((8,))
    fj = jfunc.SquaredL2Loss((8,), data=jnp.asarray(y)) * jops.FFTOperator((8,))
    value = _both(ft.apply, fj.apply, x)
    assert not value.is_complex()
    _both(ft.gradient, fj.gradient, x)


def test_squared_l2_loss_dense_complex_data(rng):
    """A complex 6 x 4 ``DenseOperator``: the least-squares node's value,
    gradient and ``A^H y`` are JAX's."""
    M, y, x = _rand(rng, (6, 4), True), _rand(rng, 6, True), _rand(rng, 4, True)
    ft = tfunc.SquaredL2Loss((6,), data=y) * tops.DenseOperator(M)
    fj = jfunc.SquaredL2Loss((6,), data=jnp.asarray(y)) * jops.DenseOperator(jnp.asarray(M))
    assert type(ft).__name__ == type(fj).__name__ == "LeastSquaresLoss"
    np.testing.assert_allclose(ft._atb.numpy(), np.asarray(fj._atb), **TIGHT)
    value = _both(ft.apply, fj.apply, x)
    assert not value.is_complex()
    _both(ft.gradient, fj.gradient, x)


def test_differentiable_loss_keeps_complex_dtype(rng):
    y = _rand(rng, 5, True)
    loss = tfunc.SquaredL2Loss((5,), data=y)
    assert loss.shift.dtype == torch.complex64
    np.testing.assert_array_equal(-loss.shift.numpy(), y)
    assert tfunc.SquaredL2Loss((5,), data=y.real.copy()).shift.dtype == torch.float32


@pytest.mark.parametrize("name", ["L1Norm", "SquaredL2Norm", "L2Norm", "LInftyNorm", "SquaredL1Norm"])
def test_complex_norms(rng, name):
    """Value, prox and ``fenchel_prox`` of a norm at a complex input."""
    x = _rand(rng, (3, 5), True)
    tol = LOOSE if name in ("LInftyNorm", "SquaredL1Norm") else TIGHT
    _close_functional(getattr(tfunc, name)((3, 5)), getattr(jfunc, name)((3, 5)), x, 0.4, tol)


@pytest.mark.parametrize("groups", [None, np.repeat(np.arange(5), 3)])
def test_complex_l21(rng, groups):
    """``L21Norm`` squares with ``|x|^2``: axis and groups modes."""
    shape = (3, 5) if groups is None else (15,)
    x = _rand(rng, shape, True)
    ft, fj = tfunc.L21Norm(shape, groups=groups), jfunc.L21Norm(shape, groups=groups)
    _close_functional(ft, fj, x, 0.5, LOOSE if groups is not None else TIGHT)


@pytest.mark.parametrize("fn", ["sign", "soft", "proj_linfty_ball", "proj_nonnegative_orthant", "proj_l2_ball",
                                "proj_l1_ball", "proj_segment"])
def test_complex_prox_functions(rng, fn):
    """The proximal maps on a complex input with zeros: the phase
    ``x / |x|``, the modulus clip, the real part's projections."""
    x = _rand(rng, 12, True) * 2
    x[[2, 7]] = 0
    args = {"sign": (), "soft": (0.5,), "proj_linfty_ball": (0.8,), "proj_nonnegative_orthant": (),
            "proj_l2_ball": (1.5,), "proj_l1_ball": (3.0,), "proj_segment": (-0.3, 0.6)}[fn]
    tol = LOOSE if fn == "proj_l1_ball" else TIGHT
    got = _both(lambda v: getattr(tprox, fn)(v, *args), lambda v: getattr(jprox, fn)(v, *args), x, tol)
    assert got.dtype == torch.complex64


# -- math/prox.py ------------------------------------------------------------


@pytest.mark.parametrize("radius", [0.5, 2.0, 100.0])
def test_proj_l1_ball(rng, radius):
    """tests/test_func.py::test_proj_l1_ball_props as parity, inside and
    outside the ball."""
    x = _rand(rng, 12) * 3
    p = _both(lambda v: tprox.proj_l1_ball(v, radius), lambda v: jprox.proj_l1_ball(v, radius), x, LOOSE)
    assert float(p.abs().sum()) <= radius + 1e-4


def test_proj_l1_ball_ties_and_2d(rng):
    x = np.round(_rand(rng, (6, 7)) * 2) / 2  # many equal magnitudes
    _both(lambda v: tprox.proj_l1_ball(v, 4.0), lambda v: jprox.proj_l1_ball(v, 4.0), x, LOOSE)


def test_lambertw(rng):
    """tests/test_func.py::test_lambertw as parity, and scipy's value."""
    from scipy.special import lambertw as scipy_w

    z = np.concatenate([[0.0, 0.5, 1.0, 5.0, 100.0, 1e4], np.abs(_rand(rng, 30)) * 20]).astype(np.float32)
    w = _both(tprox.lambertw, jprox.lambertw, z, LOOSE)
    np.testing.assert_allclose(w.numpy(), np.real(scipy_w(z.astype(np.float64))), rtol=1e-5)


def test_soft_sign_real(rng):
    x = _rand(rng, 9)
    x[3] = 0
    _both(tprox.sign, jprox.sign, x)
    _both(lambda v: tprox.soft(v, 0.4), lambda v: jprox.soft(v, 0.4), x)


# -- func/penalty.py ---------------------------------------------------------


PENALTIES = {
    "L2Norm": lambda m, s: m.L2Norm(s),
    "SquaredL2Norm": lambda m, s: m.SquaredL2Norm(s),
    "L2Ball": lambda m, s: m.L2Ball(s, radius=1.5),
    "L1Norm": lambda m, s: m.L1Norm(s),
    "SquaredL1Norm-sort": lambda m, s: m.SquaredL1Norm(s, "sort"),
    "SquaredL1Norm-root": lambda m, s: m.SquaredL1Norm(s, "root"),
    "L1Ball": lambda m, s: m.L1Ball(s, radius=2.0),
    "LInftyNorm": lambda m, s: m.LInftyNorm(s),
    "LInftyBall": lambda m, s: m.LInftyBall(s, radius=0.7),
    "L21Norm-axis": lambda m, s: m.L21Norm(s, axis=0),
    "NonNegativeOrthant": lambda m, s: m.NonNegativeOrthant(s),
    "Segment": lambda m, s: m.Segment(s, a=-0.5, b=0.5),
    "LogBarrier": lambda m, s: m.LogBarrier(s),
    "ShannonEntropy": lambda m, s: m.ShannonEntropy(s),
}
ITERATIVE = ("SquaredL1Norm-sort", "SquaredL1Norm-root", "L1Ball", "LInftyNorm", "ShannonEntropy")


@pytest.mark.parametrize("name", list(PENALTIES))
def test_penalty_matches_jax(rng, name):
    """Value, prox and ``fenchel_prox`` of every penalty at a real input
    (a positive one for the barrier and the entropy)."""
    shape = (2, 4, 5)
    x = _rand(rng, shape) * 1.5
    if name in ("LogBarrier", "ShannonEntropy"):
        x = np.abs(x) + 0.1
    ft, fj = PENALTIES[name](tfunc, shape), PENALTIES[name](jfunc, shape)
    assert ft.lipschitz == fj.lipschitz
    _close_functional(ft, fj, x, 0.7, LOOSE if name in ITERATIVE else TIGHT)


def test_l1_prox_soft(rng):
    """tests/test_func.py::test_l1_prox_soft as parity, with the ``soft`` alias."""
    x = _rand(rng, 8)
    f = tfunc.L1Norm((8,))
    _both(lambda v: f.prox(v, 0.4), lambda v: jfunc.L1Norm((8,)).prox(v, 0.4), x)
    np.testing.assert_array_equal(f.soft(torch.from_numpy(x), 0.4).numpy(), f.prox(torch.from_numpy(x), 0.4).numpy())


def test_l2_prox_block_soft(rng):
    x = _rand(rng, 8)
    _both(lambda v: tfunc.L2Norm((8,)).prox(v, 0.7), lambda v: jfunc.L2Norm((8,)).prox(v, 0.7), x)
    _both(lambda v: tfunc.L2Norm((8,)).prox(v, 100.0), lambda v: jfunc.L2Norm((8,)).prox(v, 100.0), x)


def test_sql2_grad_and_prox(rng):
    x = _rand(rng, 6)
    ft, fj = tfunc.SquaredL2Norm((6,)), jfunc.SquaredL2Norm((6,))
    _both(ft.gradient, fj.gradient, x)
    _both(lambda v: ft.prox(v, 0.5), lambda v: fj.prox(v, 0.5), x)
    assert ft.diff_lipschitz == fj.diff_lipschitz == 2.0


@pytest.mark.parametrize("tau", [0.05, 1.0, 20.0])
def test_squared_l1_sort_vs_root(rng, tau):
    """Both prox algorithms against JAX's, and against each other."""
    x = _rand(rng, 10)
    for pc in ("sort", "root"):
        _both(lambda v: tfunc.SquaredL1Norm((10,), pc).prox(v, tau),
              lambda v: jfunc.SquaredL1Norm((10,), pc).prox(v, tau), x, LOOSE)
    v = torch.from_numpy(x)
    np.testing.assert_allclose(tfunc.SquaredL1Norm((10,), "sort").prox(v, tau).numpy(),
                               tfunc.SquaredL1Norm((10,), "root").prox(v, tau).numpy(), rtol=1e-3, atol=1e-4)


def test_squared_l1_zero_and_bad_name():
    z = np.zeros(5, np.float32)
    for pc in ("sort", "root"):
        _both(lambda v: tfunc.SquaredL1Norm((5,), pc).prox(v, 0.5),
              lambda v: jfunc.SquaredL1Norm((5,), pc).prox(v, 0.5), z)
    with pytest.raises(ValueError, match="prox_computation"):
        tfunc.SquaredL1Norm((5,), "bisect")


def test_balls(rng):
    x = _rand(rng, 7) * 5
    for name in ("L2Ball", "L1Ball", "LInftyBall"):
        ft, fj = getattr(tfunc, name)((7,), 2.0), getattr(jfunc, name)((7,), 2.0)
        p = _both(lambda v: ft.prox(v, 1.0), lambda v: fj.prox(v, 1.0), x, LOOSE)
        assert float(ft(p)) == 0.0
        assert float(ft(torch.from_numpy(x))) == float(fj(jnp.asarray(x))) == float("inf")


def test_linfty_prox_moreau(rng):
    x = _rand(rng, 6)
    _both(lambda v: tfunc.LInftyNorm((6,)).prox(v, 0.5), lambda v: jfunc.LInftyNorm((6,)).prox(v, 0.5), x, LOOSE)


def test_l21_axis_mode(rng):
    x = _rand(rng, (2, 4, 4))
    _close_functional(tfunc.L21Norm((2, 4, 4), axis=0), jfunc.L21Norm((2, 4, 4), axis=0), x, 0.4)
    _close_functional(tfunc.L21Norm((2, 4, 4), axis=2), jfunc.L21Norm((2, 4, 4), axis=2), x, 0.4)


@pytest.mark.parametrize("labels", ["halves", "shuffled", "unsigned", "tiles"])
def test_l21_groups_mode(rng, labels):
    """Groups mode: contiguous halves (tests/test_func.py), labels that are
    neither sorted nor from 0, uint64 labels, and 4 x 4 tiles of an image."""
    if labels == "tiles":
        shape = (16, 16)
        groups = (np.arange(16)[:, None] // 4) * 4 + np.arange(16)[None, :] // 4
    else:
        shape = (10,)
        groups = {
            "halves": lambda: np.concatenate([np.zeros(5), np.ones(5)]),
            "shuffled": lambda: rng.choice([7, -3, 12], 10),
            "unsigned": lambda: rng.choice(np.array([7, 2**63, 12], dtype=np.uint64), 10),
        }[labels]()
    x = _rand(rng, shape)
    ft, fj = tfunc.L21Norm(shape, groups=groups), jfunc.L21Norm(shape, groups=groups)
    assert ft.mode == fj.mode == "groups" and ft.n_groups == fj.n_groups
    np.testing.assert_array_equal(ft.groups.numpy(), np.asarray(fj.groups))
    _close_functional(ft, fj, x, 0.5, LOOSE)


def test_l21_dispatch():
    """All-distinct labels build an L1Norm, one group an L2Norm, as in the
    reference."""
    for groups, cls in ((np.arange(10), "L1Norm"), (np.ones(10), "L2Norm")):
        ft, fj = tfunc.L21Norm((10,), groups=groups), jfunc.L21Norm((10,), groups=groups)
        assert type(ft).__name__ == type(fj).__name__ == cls
        assert isinstance(ft, getattr(tfunc, cls))
    assert type(tfunc.L21Norm((10,), groups=np.arange(10) // 2)) is tfunc.L21Norm


def test_indicators(rng):
    x = _rand(rng, 6)
    for name, args in (("NonNegativeOrthant", ()), ("Segment", (-0.5, 0.5))):
        ft, fj = getattr(tfunc, name)((6,), *args), getattr(jfunc, name)((6,), *args)
        _close_functional(ft, fj, x, 1.0)
        p = ft.prox(torch.from_numpy(x), 1.0)
        assert float(ft(p)) == float(fj(jnp.asarray(np.asarray(p)))) == 0.0


def test_real_and_imag_lines(rng):
    z = _rand(rng, 5, True)
    for name in ("RealLine", "ImagLine"):
        ft, fj = getattr(tfunc, name)((5,)), getattr(jfunc, name)((5,))
        _both(lambda v: ft.prox(v, 1.0), lambda v: fj.prox(v, 1.0), z)
        _both(ft.apply, fj.apply, z)
        p = ft.prox(torch.from_numpy(z), 1.0)
        assert float(ft(p)) == 0.0
    assert float(tfunc.RealLine((5,))(torch.from_numpy(z.real.copy()))) == 0.0


def test_log_barrier(rng):
    x = _rand(rng, 5)
    ft, fj = tfunc.LogBarrier((5,)), jfunc.LogBarrier((5,))
    p = _both(lambda v: ft.prox(v, 0.3), lambda v: fj.prox(v, 0.3), x)
    assert bool((p > 0).all())
    _both(ft.apply, fj.apply, x)  # +inf: some x <= 0
    _both(ft.apply, fj.apply, np.abs(x) + 0.5)


@pytest.mark.parametrize("tau", [0.01, 0.7, 50.0])
def test_shannon_entropy(rng, tau):
    """The prox (30 Newton steps) against JAX's and scipy's Lambert W form
    (tests/test_func.py::test_shannon_entropy_prox); the value at 0, at
    x < 0 (+inf) and at x > 0."""
    from scipy.special import lambertw as scipy_w

    x = np.concatenate([np.abs(_rand(rng, 8)) * 3, [0.0, 1e-6]]).astype(np.float32)
    ft, fj = tfunc.ShannonEntropy((10,)), jfunc.ShannonEntropy((10,))
    p = _both(lambda v: ft.prox(v, tau), lambda v: fj.prox(v, tau), x, LOOSE)
    if tau <= 1:
        want = np.real(tau * scipy_w(np.exp(-1 + x.astype(np.float64) / tau) / tau))
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-4, atol=1e-30)
    _both(ft.apply, fj.apply, x)
    _both(ft.apply, fj.apply, -x)


def test_quadratic_form(rng):
    """tests/test_func.py::test_quadratic_form as parity, and without an
    operator."""
    M = _rand(rng, (5, 5))
    S = M + M.T
    ot, oj = tops.DenseOperator(S), jops.DenseOperator(jnp.asarray(S))
    ot.lipschitz = oj.lipschitz = float(np.linalg.norm(S, 2))
    ft, fj = tfunc.QuadraticForm((5,), linop=ot), jfunc.QuadraticForm((5,), linop=oj)
    x = _rand(rng, 5)
    _both(ft.apply, fj.apply, x)
    _both(ft.gradient, fj.gradient, x)
    assert np.isclose(ft.diff_lipschitz, fj.diff_lipschitz) and np.isclose(ft.diff_lipschitz, 2 * ot.lipschitz)
    q0t, q0j = tfunc.QuadraticForm((5,)), jfunc.QuadraticForm((5,))
    _both(q0t.apply, q0j.apply, x)
    _both(q0t.gradient, q0j.gradient, x)
    assert q0t.diff_lipschitz == q0j.diff_lipschitz == 2.0


# -- func/loss.py ------------------------------------------------------------


LOSSES = {
    "L2Loss": lambda m, s, y: m.L2Loss(s, y),
    "SquaredL2Loss": lambda m, s, y: m.SquaredL2Loss(s, y),
    "L2BallLoss": lambda m, s, y: m.L2BallLoss(s, y, radius=1.5),
    "L1Loss": lambda m, s, y: m.L1Loss(s, y),
    "SquaredL1Loss-sort": lambda m, s, y: m.SquaredL1Loss(s, y),
    "SquaredL1Loss-root": lambda m, s, y: m.SquaredL1Loss(s, y, prox_computation="root"),
    "L1BallLoss": lambda m, s, y: m.L1BallLoss(s, y, radius=2.0),
    "LInftyLoss": lambda m, s, y: m.LInftyLoss(s, y),
    "LInftyBallLoss": lambda m, s, y: m.LInftyBallLoss(s, y, radius=0.7),
    "ConsistencyLoss": lambda m, s, y: m.ConsistencyLoss(s, y),
    "KLDivergence": lambda m, s, y: m.KLDivergence(s, y),
    "ProximableLoss-L2Norm": lambda m, s, y: m.ProximableLoss(m.L2Norm(s), y),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(rng, name):
    """Every loss: value, prox and ``fenchel_prox`` (positive data and
    inputs for the divergence)."""
    shape = (3, 7)
    y, x = _rand(rng, shape), _rand(rng, shape) * 2
    if name == "KLDivergence":
        y, x = np.abs(y) + 0.1, np.abs(x) + 0.1
    ft, fj = LOSSES[name](tfunc, shape, y), LOSSES[name](jfunc, shape, jnp.asarray(y))
    tol = LOOSE if any(k in name for k in ("SquaredL1", "L1Ball", "LInfty")) else TIGHT
    _close_functional(ft, fj, x, 0.6, tol)
    if name == "SquaredL2Loss":
        _both(ft.gradient, fj.gradient, x)
        assert ft.diff_lipschitz == fj.diff_lipschitz == 2.0


@pytest.mark.parametrize("name", ["L2Loss", "L1Loss", "SquaredL2Loss", "LInftyBallLoss", "ConsistencyLoss"])
def test_losses_take_complex_data_and_a_device(rng, name):
    """Complex data stay complex; ``device=`` places the data."""
    y, x = _rand(rng, 6, True), _rand(rng, 6, True)
    ft, fj = LOSSES[name](tfunc, (6,), y), LOSSES[name](jfunc, (6,), jnp.asarray(y))
    assert getattr(tfunc, name)((6,), y, device="cpu").device == torch.device("cpu")
    tol = LOOSE if "LInfty" in name else TIGHT
    _both(ft.apply, fj.apply, x, tol)
    _both(lambda v: ft.prox(v, 0.6), lambda v: fj.prox(v, 0.6), x, tol)


def test_losses_shift_rule(rng):
    """tests/test_func.py::test_losses_shift_rule as parity."""
    y, x = _rand(rng, 6), _rand(rng, 6)
    st, sj = tfunc.SquaredL2Loss((6,), data=y), jfunc.SquaredL2Loss((6,), data=jnp.asarray(y))
    _both(st.apply, sj.apply, x)
    _both(st.gradient, sj.gradient, x)
    lt, lj = tfunc.L1Loss((6,), data=y), jfunc.L1Loss((6,), data=jnp.asarray(y))
    p = _both(lambda v: lt.prox(v, 0.5), lambda v: lj.prox(v, 0.5), x)
    np.testing.assert_allclose(p.numpy(), np.asarray(jprox.soft(jnp.asarray(x - y), 0.5)) + y, **TIGHT)


def test_loss_compose_operator_is_differentiable(rng):
    """tests/test_func.py::test_loss_compose_operator_is_differentiable as
    parity: the least-squares node, its gradient and beta."""
    from pycsou_tpu_torch.core.map import DifferentiableMap

    G = _rand(rng, (7, 5))
    gt, gj = tops.DenseOperator(G), jops.DenseOperator(jnp.asarray(G))
    gt.lipschitz = gj.lipschitz = float(np.linalg.norm(G, 2))
    y, x = _rand(rng, 7), _rand(rng, 5)
    Ft, Fj = tfunc.SquaredL2Loss((7,), data=y) * gt, jfunc.SquaredL2Loss((7,), data=jnp.asarray(y)) * gj
    assert isinstance(Ft, DifferentiableMap)
    _both(Ft.apply, Fj.apply, x)
    _both(Ft.gradient, Fj.gradient, x)
    assert np.isclose(Ft.diff_lipschitz, Fj.diff_lipschitz, rtol=1e-6)


def test_consistency_prox(rng):
    y, x = _rand(rng, (2, 3)), _rand(rng, (2, 3))
    ft, fj = tfunc.ConsistencyLoss((2, 3), y), jfunc.ConsistencyLoss((2, 3), jnp.asarray(y))
    p = _both(lambda v: ft.prox(v, 1.0), lambda v: fj.prox(v, 1.0), x)
    np.testing.assert_array_equal(p.numpy(), y)
    assert float(ft(p)) == 0.0 and float(ft(torch.from_numpy(x))) == float("inf")


def test_kl_divergence_edges(rng):
    """``y == 0`` entries contribute ``x``, ``x == 0`` with ``y > 0`` gives
    +inf through the log, any ``x < 0`` gives +inf; the prox at ``y == 0``;
    tests/test_func.py::test_kl_divergence's identities."""
    y = np.abs(_rand(rng, 8)) + 0.5
    y[[1, 4]] = 0.0
    x = np.abs(_rand(rng, 8)) + 0.5
    ft, fj = tfunc.KLDivergence((8,), y), jfunc.KLDivergence((8,), jnp.asarray(y))
    _close_functional(ft, fj, x, 0.4)
    assert float(ft(torch.from_numpy(y))) < 1e-5
    for probe in (np.where(np.arange(8) == 2, -0.1, x), np.where(np.arange(8) == 4, 0.0, x),
                  np.where(np.arange(8) == 3, 0.0, x)):
        _both(ft.apply, fj.apply, probe.astype(np.float32))
    assert float(ft(torch.from_numpy(np.where(np.arange(8) == 2, -0.1, x).astype(np.float32)))) == float("inf")
    _both(lambda v: ft.prox(v, 0.0), lambda v: fj.prox(v, 0.0), x)


# -- utils/misc.py and the exports -------------------------------------------


def test_misc_matches_jax(rng):
    """``peaks`` on a grid and at 0 (tests/test_aux.py::test_peaks), and the
    range-broadcasting helpers."""
    g = np.linspace(-3, 3, 33).astype(np.float32)
    xx, yy = np.meshgrid(g, g)
    got = tmisc.peaks(torch.from_numpy(xx), torch.from_numpy(yy))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmisc.peaks(jnp.asarray(xx), jnp.asarray(yy))), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tmisc.peaks(0.0, 0.0)), 3 * np.exp(-1) - 1 / 3 * np.exp(-1), rtol=1e-5)
    for a, b in (((3, 4), (3, 4)), ((1, 4), (5, 4)), ((3, 4), (2, 4)), ((3, 4), (3, 5))):
        assert tmisc.is_range_broadcastable(a, b) == jmisc.is_range_broadcastable(a, b)
        if jmisc.is_range_broadcastable(a, b):
            assert tmisc.range_broadcast_shape(a, b) == jmisc.range_broadcast_shape(a, b)
        else:
            with pytest.raises(ValueError):
                tmisc.range_broadcast_shape(a, b)


@pytest.mark.parametrize("module", ["func.loss", "func.penalty", "math.prox", "math.green", "utils.misc",
                                    "ops.sampling", "func", "math"])
def test_every_reference_name_exists(module):
    """Every public name of the reference's module exists in the port's."""
    import importlib

    ref = importlib.import_module(f"pycsou_tpu.{module}")
    port = importlib.import_module(f"pycsou_tpu_torch.{module}")
    names = getattr(ref, "__all__", None) or [n for n in vars(ref) if not n.startswith("_") and n[0].isupper()
                                              or n in ("lambertw", "sign", "soft") or n.startswith("proj_")]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing


# -- the slice end to end ----------------------------------------------------


def _gauss(k=7, s=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _peaks_image(n):
    g = np.linspace(-3, 3, n).astype(np.float32)
    xx, yy = np.meshgrid(g, g)
    p = np.maximum(np.asarray(jmisc.peaks(jnp.asarray(xx), jnp.asarray(yy))), 0)
    return (100 * p / p.max()).astype(np.float32)


def _close_iterates(ts, js, keys, n):
    for k in keys:
        want = np.asarray(js[k])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(ts[k].numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=f"{k} after {n}")


def test_poisson_tv_pds_matches_jax():
    """Poisson-TV deblurring at 64 x 64: ``PDS(G=NonNegativeOrthant,
    H=ProxFuncHStack([KLDivergence(y), 0.5 * L21Norm]), K=LinOpVStack([A,
    Gradient]))`` on a band ``Convolve2D`` (the generic chain), 20
    iterations against the JAX solver."""
    n = 64
    x_true = _peaks_image(n)
    h = _gauss()
    A_j = jops.Convolve2D((n, n), jnp.asarray(h))
    y = np.random.default_rng(17).poisson(np.maximum(np.asarray(A_j(jnp.asarray(x_true))), 0)).astype(np.float32)

    def build(m, ops, opt, data):
        A = ops.Convolve2D((n, n), data(h))
        H = m.ProxFuncHStack([m.KLDivergence((n, n), data(y)), 0.5 * m.L21Norm((2, n, n), axis=0)])
        K = ops.LinOpVStack([A, ops.Gradient((n, n))])
        return opt.PDS((n, n), G=m.NonNegativeOrthant((n, n)), H=H, K=K, max_iter=100)

    ts = build(tfunc, tops, topt, torch.from_numpy)
    js = build(jfunc, jops, jopt, jnp.asarray)
    assert ts._fused is None
    assert np.isclose(ts.tau, js.tau, rtol=1e-6) and np.isclose(ts.sigma, js.sigma, rtol=1e-6)
    _close_iterates(ts.run_fixed(20), js.run_fixed(20), ("x", "z"), 20)


def test_group_lasso_matches_jax():
    """The group LASSO at 64 x 64: ``APGD(F=SquaredL2Loss(y) * A, G=0.01 *
    L21Norm(groups=8 x 8 tiles))`` (no fusion: ``match_lasso`` takes
    ``L1Norm`` only), 20 iterations against the JAX solver."""
    n, t = 64, 8
    rng = np.random.default_rng(19)
    tiles = (np.arange(n)[:, None] // t) * (n // t) + np.arange(n)[None, :] // t
    on = rng.random((n // t) ** 2) < 0.1
    x_true = np.where(on[tiles], 3.0, 0.0).astype(np.float32)
    h = _gauss()
    A_j = jops.Convolve2D((n, n), jnp.asarray(h))
    y = (np.asarray(A_j(jnp.asarray(x_true))) + 0.01 * rng.standard_normal((n, n))).astype(np.float32)

    def build(m, ops, opt, data):
        A = ops.Convolve2D((n, n), data(h))
        G = 0.01 * m.L21Norm((n, n), groups=tiles)
        return opt.APGD((n, n), F=m.SquaredL2Loss((n, n), data(y)) * A, G=G, max_iter=100)

    ts, js = build(tfunc, tops, topt, torch.from_numpy), build(jfunc, jops, jopt, jnp.asarray)
    assert ts._fused is None
    _close_iterates(ts.run_fixed(20), js.run_fixed(20), ("x", "x_temp"), 20)
