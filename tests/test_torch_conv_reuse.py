"""The fused TV and LASSO engines take the user's ``Convolve2D`` as it is
(``ops/conv.py`` ``engine_conv``), on the CPU.

A ``PDS`` or ``APGD`` of ``SquaredL2Loss(y) * A`` (or ``* (Masking * A)``)
must give the engine that the same solver builds from the PSF's taps, the
array the matcher handed it before the operator was reused: the same
engine, taps, steps, ``beta`` and ``A^H y``, and iterates equal bit for bit
after 40 iterations.  With ``A`` built, a ``PDS(...)`` computes no FFT
bound and counts ``pds.conv_reused`` once; an operator the engine does not
take as it is (a forced method, another device or domain) and a tensor PSF
are built from their taps, as before.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.ops.conv as tconv
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.opt import fuse
from pycsou_tpu_torch.utils import profiling
from pycsou_tpu_torch.utils.device import set_default_device

SHAPE = (48, 64)
LAM = 0.05


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


def _gaussian(k=15, s=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _motion2():
    """A rank-2 motion blur: a 9-tap horizontal and a 7-tap vertical streak
    through the centre of a 9 x 9 window."""
    h = np.zeros((9, 9))
    h[4, :] += 1.0 / 9
    h[1:8, 4] += 1.0 / 7
    return (h / h.sum()).astype(np.float32)


def _near_rank1():
    """The Gaussian with a small random perturbation: full rank, truncated
    to rank 1 by ``svd_tol``."""
    rng = np.random.default_rng(3)
    return (_gaussian(11, 1.5) + 1e-4 * rng.random((11, 11))).astype(np.float32)


# name: (PSF, Convolve2D keywords)
PSFS = {
    "gauss15": (_gaussian(), {}),
    "motion_rank2": (_motion2(), {}),
    "box5": (np.full((5, 5), 1.0 / 25, np.float32), {}),
    "random17_full_rank": (np.abs(np.random.default_rng(7).standard_normal((17, 17))).astype(np.float32), {}),
    "identity1": (np.ones((1, 1), np.float32), {}),
    "svd_truncated": (_near_rank1(), {"svd_tol": 1e-2}),
}


def _observation(A, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(SHAPE, generator=g)
    return A(x) + 0.01 * torch.randn(SHAPE, generator=g)


def _tv_pds(F):
    return topt.PDS(SHAPE, F=F, G=tfunc.NonNegativeOrthant(SHAPE), H=LAM * tfunc.L21Norm((2,) + SHAPE, axis=0),
                    K=tops.Gradient(SHAPE))


def _problems(A, taps, flavour):
    """``(generic solver, its fused engine, the engine built from the
    taps)`` for ``flavour``: TV deconvolution, TV with a keep mask after the
    convolution (combined mode), or the LASSO by APGD."""
    y = _observation(A)
    if flavour == "conv":
        p = _tv_pds(tfunc.SquaredL2Loss(SHAPE, data=y) * A)
        ref = topt.TVDeconvolution(SHAPE, y, LAM, filt=taps, nonneg=True, tau=p.tau, sigma=p.sigma, rho=p.rho)
    elif flavour == "combined":
        keep = torch.rand(SHAPE, generator=torch.Generator().manual_seed(1)) < 0.7
        M = tops.Masking(SHAPE, keep)
        p = _tv_pds(tfunc.SquaredL2Loss(M.codim_shape, data=y[keep]) * (M * A))
        mask, y_img = fuse._back_projection(M, y[keep])
        ref = topt.TVDeconvolution(SHAPE, y_img, LAM, filt=taps, mask=mask, nonneg=True, tau=p.tau,
                                   sigma=p.sigma, rho=p.rho)
    else:
        p = topt.APGD(SHAPE, F=tfunc.SquaredL2Loss(SHAPE, data=y) * A, G=LAM * tfunc.L1Norm(SHAPE))
        ref = topt.LassoDeconvolution(SHAPE, y, LAM, filt=taps, tau=p.tau, acceleration=p.acceleration, d=p.d)
    return p, p._fused, ref


@pytest.mark.parametrize("flavour", ["conv", "combined", "lasso"])
@pytest.mark.parametrize("psf", list(PSFS))
def test_reused_operator_gives_the_engine_built_from_the_taps(psf, flavour):
    h, kw = PSFS[psf]
    A = tops.Convolve2D(SHAPE, h, **kw)
    taps = A.filt.numpy().copy()  # the array the matcher handed the engine before
    p, eng, ref = _problems(A, taps, flavour)
    assert type(eng) is type(ref)
    assert eng.filt is A.filt  # the operator's own taps: it was taken as it is
    assert torch.equal(eng.filt, ref.filt)
    assert eng.beta == ref.beta and eng.tau == ref.tau
    assert torch.equal(eng.atb, ref.atb)
    if flavour == "lasso":
        assert eng.engine == ref.engine
    else:
        assert eng.stencil_mode == ref.stencil_mode and eng.sigma == ref.sigma
    got, want = eng.run_fixed(40), ref.run_fixed(40)
    assert got.keys() == want.keys()
    for k, v in want.items():  # exactly; the histories' unfilled slots are NaN on both sides
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, equal_nan=True, msg=k)
    # the generic solver steps its fused engine: the same iterate
    assert torch.equal(p.run_fixed(40)["x"], want["x"])


@pytest.fixture
def lipschitz_calls(monkeypatch):
    """The number of ``_fft_lipschitz`` calls since the fixture began."""
    calls = []
    real = tconv._fft_lipschitz
    monkeypatch.setattr(tconv, "_fft_lipschitz", lambda *a: calls.append(a) or real(*a))
    return calls


def _counted(build):
    """``(build(), the pds.conv_reused count)`` with a profiler running."""
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = build()
        return out, profiling.counters().get("pds.conv_reused", 0)
    finally:
        profiling.reset()


@pytest.mark.parametrize("case", ["auto", "forced method", "tensor PSF", "other device", "other domain"])
def test_a_built_operator_is_not_built_again(case, lipschitz_calls):
    # the full-rank PSF ('fft') where the copy goes to the meta device,
    # whose tensors hold no data for the band factors' host copy
    h = PSFS["random17_full_rank"][0] if case == "other device" else _gaussian()
    A = tops.Convolve2D(SHAPE, h, method="fft" if case == "forced method" else "auto")
    y = _observation(A)
    lipschitz_calls.clear()
    if case in ("auto", "forced method"):
        p, n = _counted(lambda: _tv_pds(tfunc.SquaredL2Loss(SHAPE, data=y) * A))
        conv = p._fused.gram
        assert p._fused.stencil_mode == "plain"
    elif case == "tensor PSF":
        t, n = _counted(lambda: topt.TVDeconvolution(SHAPE, y, LAM, filt=torch.from_numpy(h)))
        conv = t.gram
    else:
        shape, dev = ((32, 40), "cpu") if case == "other domain" else (SHAPE, "meta")
        conv, n = _counted(lambda: tconv.engine_conv(shape, A, torch.device(dev)))
        assert conv is not A and conv.method == A.method and tuple(conv.dim_shape) == shape
        assert conv.device.type == dev
        if dev == "cpu":
            assert torch.equal(conv.filt, A.filt)
    if case == "auto":
        assert (len(lipschitz_calls), n) == (0, 1)
        assert conv.fwd is A.fwd  # the operator's own factors
    else:
        assert (len(lipschitz_calls), n) == (1, 0)
    if case == "forced method":
        # built from the taps with the method 'auto' picks, as before
        assert conv.fwd is not A.fwd and isinstance(conv, tconv.SeparableConvGram2D)
