"""The 1-D, N-D and circular convolutions of the port (ops/conv.py
Convolve1D, ConvGram1D, MovingAverage1D/2D, ConvolveND, ConvGramND,
SeparableConvGramND, CircularConvolve; ops/_gram.py's N-D half;
kernels/band.py gram_band_axis) on the CPU, against the JAX package on the
same numpy inputs.

Tolerances, on max(1, max |reference|) for the absolute part:
* an FFT or a convolution against the JAX one (another FFT library,
  another summation order): rtol 3e-4 / atol 3e-5;
* elementwise work and same-order sums (the Gram's pick, ``"auto"``'s
  method, numpy plans): rtol 1e-5 / atol 1e-6;
* ``lipschitz``: bit-equal where both packages compute it with the same
  numpy code (``_fft_lipschitz``; ``CircularConvolve`` from a given
  ``h_hat``), rtol 1e-6 where each package takes its own float32 FFT of
  the filter (``CircularConvolve`` from ``filt``);
* APGD on cfg1 after 20 iterations: rtol 1e-4 / atol 1e-5 x max |x|
  (tests/test_torch_slice.py's rule), tau bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.ops.conv as jconv
import pycsou_tpu.opt as jopt
from pycsou_tpu.kernels.band import gram_band_axis as j_gram_band_axis
from pycsou_tpu.kernels.band import make_gram_band as j_make_gram_band
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops.conv as tconv
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.kernels.band import gram_band_axis, make_gram_band
from pycsou_tpu_torch.utils.convert import transfer_from_numpy
from pycsou_tpu_torch.utils.device import set_default_device

FFT_TOL = dict(rtol=3e-4, atol=3e-5)
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=FFT_TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * max(1.0, float(np.abs(want).max())))


def _assert_like_jax(op, jop, rng, gram=True):
    """apply, adjoint and (with ``gram``) the Gram of the port's operator
    against the JAX operator's on one draw; ``lipschitz`` bit-equal."""
    x = rng.standard_normal(op.dim_shape).astype(np.float32)
    y = rng.standard_normal(op.codim_shape).astype(np.float32)
    # each JAX side traced into one jit: eager, every small op compiles
    _close(op.apply(_t(x)), jax.jit(lambda v: jop.apply(v))(jnp.asarray(x)))
    _close(op.adjoint(_t(y)), jax.jit(lambda v: jop.adjoint(v))(jnp.asarray(y)))
    if gram:
        jg = jop.gram
        _close(op.gram.apply(_t(x)), jax.jit(lambda v: jg.apply(v))(jnp.asarray(x)))
        assert type(op.gram).__name__ == type(jg).__name__
    assert op.lipschitz == jop.lipschitz


@pytest.mark.parametrize(
    "method,m,n",
    [("direct", 4, 300), ("direct", 5, 301), ("fft", 4, 300), ("fft", 5, 301),
     ("overlap-add", 4, 1000), ("overlap-add", 5, 1008), ("overlap-add", 5, 1000), ("auto", 33, 2**18)],
)
def test_convolve1d_matches_jax(method, m, n):
    """Each method with odd and even taps; overlap-add on lengths that are
    (1008 = 4 chunks of 252 at 5 taps; 2**18 = 1024 chunks of 256 at 33
    taps, ``"auto"``'s pick) and are not chunk multiples."""
    rng = np.random.default_rng(m * 1000 + n)
    h = rng.standard_normal(m).astype(np.float32)
    A = tconv.Convolve1D((n,), h, method=method)
    jA = jconv.Convolve1D((n,), jnp.asarray(h), method=method)
    assert A.method == jA.method == ("overlap-add" if method == "auto" else method)
    _assert_like_jax(A, jA, rng)


def test_convolve1d_auto_matches_jax():
    """``"auto"`` on a grid of (n, m) that crosses 32 taps, 2**18 samples
    and m = n / 8."""
    for n in (2**18 - 1, 2**18):
        for m in (31, 32, 33, n // 8, n // 8 + 1):
            h = np.ones(m, np.float32) / m
            assert tconv.Convolve1D((n,), h).method == jconv.Convolve1D((n,), jnp.asarray(h)).method, (n, m)


def test_moving_averages_match_jax():
    """MovingAverage1D ('direct') and MovingAverage2D (a rank-1 box: 'band',
    K1's plain version here), not batchable in 2-D."""
    rng = np.random.default_rng(3)
    M1, jM1 = tconv.MovingAverage1D((50,), 4), jconv.MovingAverage1D((50,), 4)
    assert M1.method == jM1.method == "direct"
    _assert_like_jax(M1, jM1, rng)
    M2, jM2 = tconv.MovingAverage2D((24, 20), (5, 3)), jconv.MovingAverage2D((24, 20), (5, 3))
    assert M2.method == jM2.method == "band"
    assert not M2.batchable
    _assert_like_jax(M2, jM2, rng, gram=False)
    jg = jM2.gram
    _close(M2.gram.apply(_t(np.ones((24, 20)))), jax.jit(lambda v: jg.apply(v))(jnp.ones((24, 20))))


def _rank1(*taps_per_axis):
    out = np.asarray(taps_per_axis[0], np.float64)
    for u in taps_per_axis[1:]:
        out = np.multiply.outer(out, np.asarray(u, np.float64))
    return out.astype(np.float32)


@pytest.mark.parametrize(
    "shape,filt_shape,rank1",
    [((12, 14), (3, 4), False), ((12, 15), (3, 4), True), ((9, 10, 11), (3, 2, 3), False),
     ((9, 10, 12), (3, 1, 4), True)],
)
def test_convolvend_matches_jax(shape, filt_shape, rank1):
    """2-D and 3-D, full-rank (the FFT Gram) and rank-1 (the band Gram, one
    filter axis of length 1 in 3-D) filters."""
    rng = np.random.default_rng(sum(shape))
    if rank1:
        h = _rank1(*[rng.standard_normal(k) for k in filt_shape])
    else:
        h = rng.standard_normal(filt_shape).astype(np.float32)
    A, jA = tconv.ConvolveND(shape, h), jconv.ConvolveND(shape, jnp.asarray(h))
    _assert_like_jax(A, jA, rng)
    assert type(A.gram).__name__ == ("SeparableConvGramND" if rank1 else "ConvGramND")
    x = rng.standard_normal(shape).astype(np.float32)
    _close(A.gram.apply(_t(x)), A.adjoint(A.apply(_t(x))))


@pytest.mark.parametrize(
    "shape,filt,want",
    [
        ((200,), np.ones(65, np.float32), "SeparableConvGramND"),  # 2 (m - 1) = 128
        ((200,), np.ones(66, np.float32), "ConvGramND"),  # 2 (m - 1) = 130 > 128
        ((9, 14), _rank1(np.ones(3), np.arange(1.0, 6.0)), "ConvGramND"),  # 14 < 3 x 5
        ((9, 15), _rank1(np.ones(3), np.arange(1.0, 6.0)), "SeparableConvGramND"),  # 15 = 3 x 5
        ((9, 15), _rank1(np.ones(3), np.arange(1.0, 6.0)) + np.eye(3, 5, dtype=np.float32), "ConvGramND"),
        ((9, 12), _rank1([1.0], [1.0, 2.0, 3.0, 1.0]), "SeparableConvGramND"),  # a 1-tap axis
        ((9, 10, 12), _rank1([1.0, 2.0, 1.0], [1.0], [3.0, 1.0, 2.0, 1.0]), "SeparableConvGramND"),
    ],
)
def test_gram_pick_matches_jax(shape, filt, want):
    """``ConvolveND.gram`` takes what the reference takes on every gate of
    ``SeparableConvGramND.build``: the band reach, n >= 3m, rank 1, a
    1-tap axis."""
    got = type(tconv.ConvolveND(shape, filt).gram).__name__
    assert got == type(jconv.ConvolveND(shape, jnp.asarray(filt)).gram).__name__ == want


def test_complex_filters_raise_like_jax():
    """The complex-dtype gate: the reference's ConvolveND cannot be built
    from a complex filter (its rfftn refuses), nor can the port's."""
    h = np.ones((3, 3), np.complex64)
    with pytest.raises(ValueError):
        jconv.ConvolveND((8, 8), h, dtype=jnp.complex64)
    with pytest.raises(ValueError):
        tconv.ConvolveND((8, 8), h)


def test_gram_band_axis_matches_jax():
    """The band Gram along each axis of a 3-D tensor (odd and even taps)
    against the reference's banded passes; the plan's numpy bit-equal."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 13, 14)).astype(np.float32)
    for taps in (rng.standard_normal(3), rng.standard_normal(4)):
        acorr, Et, Eb, L = make_gram_band(taps, 12)
        (_, jEt, jEb, jL) = j_make_gram_band(taps, 12)
        assert L == jL and np.array_equal(Et, jEt) and np.array_equal(Eb, jEb)
        for ax in range(3):
            n = x.shape[ax]
            acorr, Et, Eb, L = make_gram_band(taps, n)
            plan, jplan = (_t(acorr), _t(Et), _t(Eb), L), j_make_gram_band(taps, n)
            want = jax.jit(lambda v: j_gram_band_axis(v, jplan, ax))(jnp.asarray(x))
            _close(gram_band_axis(_t(x), plan, ax), want)


def test_circular_convolve_matches_jax():
    """From ``filt`` and from the JAX ``h_hat`` (its re/im pair), ``pinv``
    with and without ``damp``, and the Gram (``A^H o A``)."""
    rng = np.random.default_rng(5)
    shape = (8, 9)
    h = rng.standard_normal((3, 4)).astype(np.float32)
    A, jA = tconv.CircularConvolve(shape, h), jconv.CircularConvolve(shape, jnp.asarray(h))
    x = rng.standard_normal(shape).astype(np.float32)
    for got, want in ((A.apply(_t(x)), jA.apply(jnp.asarray(x))), (A.adjoint(_t(x)), jA.adjoint(jnp.asarray(x))),
                      (A.gram.apply(_t(x)), jA.gram.apply(jnp.asarray(x))),
                      (A.pinv(_t(x)), jA.pinv(jnp.asarray(x))),
                      (A.pinv(_t(x), damp=0.1), jA.pinv(jnp.asarray(x), damp=0.1))):
        _close(got, want)
    np.testing.assert_allclose(A.lipschitz, jA.lipschitz, rtol=1e-6)
    hh = transfer_from_numpy(np.asarray(jA.h_hat_re), np.asarray(jA.h_hat_im))
    B = tconv.CircularConvolve(shape, h_hat=hh)
    assert B.lipschitz == jA.lipschitz
    _close(B.apply(_t(x)), jA.apply(jnp.asarray(x)))
    _close(B.pinv(_t(x), damp=0.1), jA.pinv(jnp.asarray(x), damp=0.1))


def test_batchable_flags():
    """Every new operator but MovingAverage2D's band ``Convolve2D`` maps
    through ``torch.func.vmap``, row for row as one call a row."""
    rng = np.random.default_rng(9)
    h3 = rng.standard_normal((3, 2, 3)).astype(np.float32)
    ops = [tconv.Convolve1D((300,), rng.standard_normal(5), method=m) for m in ("direct", "fft", "overlap-add")]
    ops += [tconv.MovingAverage1D((40,), 3), tconv.ConvolveND((9, 10, 11), h3),
            tconv.ConvolveND((9, 10, 12), _rank1([1.0, 2.0, 1.0], [1.0], [3.0, 1.0, 2.0, 1.0])),
            tconv.CircularConvolve((8, 9), rng.standard_normal((3, 4)))]
    ops += [op.gram for op in ops]
    for op in ops:
        assert op.batchable, type(op).__name__
        xs = _t(rng.standard_normal((3,) + op.dim_shape))
        _close(op.apply_batched(xs), torch.stack([op.apply(x) for x in xs]), EXACT_TOL)
    assert not tconv.MovingAverage2D((24, 20), (5, 3)).batchable


def _cfg1(ops, funcs, opt, asarray):
    """bench.py sec_cfg1_lasso1d's problem in either package."""
    n = 256
    rng = np.random.default_rng(1)
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, 12, replace=False)] = rng.standard_normal(12).astype(np.float32) + 2.0
    g = np.exp(-((np.arange(9) - 4) ** 2) / (2 * 1.5**2)).astype(np.float32)
    g /= g.sum()
    A = ops.Convolve1D((n,), g)
    y = np.asarray(A(asarray(x_true))) + 0.01 * rng.standard_normal(n).astype(np.float32)
    return opt.APGD((n,), F=funcs.SquaredL2Loss((n,), data=asarray(y)) * A, G=0.01 * funcs.L1Norm((n,)),
                    max_iter=3000, min_iter=10, accuracy_threshold=1e-6)


def test_cfg1_apgd_matches_jax():
    """cfg1 (``APGD`` on ``Convolve1D`` 'direct', its gradient through
    ``ConvGram1D``): tau bit-equal, iterates after 20 iterations."""
    solver = _cfg1(tconv, tfunc, topt, _t)
    jsolver = _cfg1(jconv, jfunc, jopt, jnp.asarray)
    assert solver.tau == jsolver.tau
    st, jst = solver.run_fixed(20), jsolver.run_fixed(20)
    scale = max(1.0, float(np.abs(np.asarray(jst["x"])).max()))
    for k in ("x", "x_temp"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=1e-4, atol=1e-5 * scale)
