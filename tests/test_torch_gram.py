"""Convolve2D's other methods and the FFT Gram of the port (ops/_gram.py
ConvGram2D, 'bandg', 'direct', svd_tol) on the CPU, against the JAX package
on the same numpy inputs, and the TV solver on PSFs outside the band gate.

Tolerances, relative to max(1, max |reference|) unless stated:
* the FFT Gram against the JAX Gram: 1e-5 (the same FFTs and corrections
  in float32, another FFT library); against ``adjoint(apply(x))``: 1e-5;
* 'direct' against the JAX 'direct': rtol 3e-4 / atol 3e-5 (F.conv2d
  against lax.conv, summed in another order), as the band tests of
  tests/test_torch_ops.py;
* 'bandg' against the reference's grouped sweeps in interpret mode: rtol
  3e-4 / atol 3e-5 (the TPU kernel's bf16x3 dots against f32 FMAs);
* svd_tol: the truncated PSF bit for bit, its bound exactly (the same
  numpy code);
* TVDeconvolution after 6 iterations: rtol 1e-4 / atol 1e-5 x max |x|
  (tests/test_torch_slice.py's _assert_iterates_close).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.ops.conv as jconv
import pycsou_tpu.opt as jopt
from pycsou_tpu.kernels.conv2d import sepconv2d_sweep
from pycsou_tpu.ops import _gram as jgram
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.ops.conv as tconv
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.opt.tv import conv_engine, masked_engine
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


LAM = 0.05


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rel_close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


def _lowrank_psf(seed, rank, K0, K1=None):
    """A rank-``rank`` PSF of K0 x K1 taps (a sum of ``rank`` random outer
    products), normalised to unit l1 norm, as bench.py sec_rank6 builds its
    PSF."""
    r = np.random.default_rng(seed)
    u = r.standard_normal((K0, rank))
    v = r.standard_normal((K1 or K0, rank))
    h = (u @ v.T).astype(np.float32)
    return h / np.abs(h).sum()


def _fullrank_psf(seed, K):
    """|N(0, 1)| taps, normalised (bench.py sec_fullrank)."""
    h = np.abs(np.random.default_rng(seed).standard_normal((K, K))).astype(np.float32)
    return h / h.sum()


def _jax_gram(x, h, wrap: bool):
    """The JAX package's Gram of x: ``make_conv2d_gram(_wrap)`` and the
    cache of ``pycsou_tpu/ops/_gram.py``, then ``conv2d_gram_apply(_wrap)``,
    as ``ConvGram2D`` runs them, traced into one jit (one compile, not one
    per eager operation)."""
    def gram(x, h):
        if wrap:
            return jgram.conv2d_gram_apply_wrap(
                x, h, jgram.make_conv2d_gram_wrap(x.shape, h), cache=jgram.make_wrap_cache(x.shape, h))
        h2_hat, L = jgram.make_conv2d_gram(x.shape, h)
        return jgram.conv2d_gram_apply(x, h, h2_hat, L, cache=jgram.make_pad_cache(x.shape, h))

    return np.asarray(jax.jit(gram)(jnp.asarray(x), jnp.asarray(h)))


def _check_gram(rng, kshape, shape, wrap):
    """The port's ConvGram2D path against the JAX one and against
    adjoint(apply(x)) of the 'fft' convolution, each within 1e-5."""
    h = rng.standard_normal(kshape).astype(np.float32)
    A = tconv.Convolve2D(shape, h, method="fft")
    G = tconv.ConvGram2D(A, wrap=wrap)
    assert G.wrap == wrap
    x = rng.standard_normal(shape).astype(np.float32)
    got = G.apply(_t(x))
    assert tuple(got.shape) == shape
    _rel_close(got, _jax_gram(x, h, wrap), 1e-5)
    _rel_close(got, A.adjoint(A.apply(_t(x))), 1e-5)


@pytest.mark.parametrize("kshape", [(3, 3), (5, 5), (4, 4), (5, 4), (1, 3), (7, 2)])
@pytest.mark.parametrize("shape", [(16, 16), (17, 13)])
def test_gram_padded_matches_jax(rng, kshape, shape):
    """The padded path (conv2d_gram_apply, frame corrections) against the
    JAX one and against adjoint(apply(x)); 17 x 13 round-trips odd FFT
    sizes through irfft2(s=)."""
    _check_gram(rng, kshape, shape, wrap=False)


@pytest.mark.parametrize("kshape", [(3, 3), (5, 5), (4, 4), (5, 4), (7, 2)])
@pytest.mark.parametrize("shape", [(32, 32), (64, 48), (48, 32)])
def test_gram_wrap_matches_jax(rng, kshape, shape):
    """The wrap path (conv2d_gram_apply_wrap: the rolls, the 2p:3p slices,
    the corners added back) against the JAX one and adjoint(apply(x)), on
    non-square images and even and odd kernels."""
    _check_gram(rng, kshape, shape, wrap=True)


@pytest.mark.parametrize("kshape", [(5, 5), (7, 2), (2, 7)])
@pytest.mark.parametrize("shape", [(5, 4), (3, 3), (2, 9)])
def test_gram_small_images(rng, kshape, shape):
    """Images under the kernel's size (n0 < m0 - 1 in the bottom slab, strips
    partly outside the image in _corr_into's clipping): the padded path
    against the JAX one and adjoint(apply(x))."""
    _check_gram(rng, kshape, shape, wrap=False)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("method", ["fft", "direct"])
def test_gram_is_adjoint_of_apply(rng, wrap, method):
    """Both paths of a 'fft' and a 'direct' convolution's Gram equal
    adjoint(apply(x)); the Gram is self-adjoint; its transfers lie on the
    convolution's device; Convolve2D.gram dispatches to ConvGram2D."""
    shape, h = (64, 48), rng.standard_normal((5, 6)).astype(np.float32)
    A = tconv.Convolve2D(shape, h, method=method)
    assert type(A.gram) is tops.ConvGram2D and A.gram.wrap  # fast sizes, n >= 4 m
    G = tconv.ConvGram2D(A, wrap=wrap)
    x = _t(rng.standard_normal(shape))
    _rel_close(G.apply(x), A.adjoint(A.apply(x)), 1e-5)
    _rel_close(G.adjoint(x), G.apply(x), 0.0)
    assert G.device == A.device and G.lipschitz == A.lipschitz**2
    assert all(v.device == A.device for v in [G.h2_hat, *G.cache.values()])


def test_gram_auto_policy(rng, monkeypatch):
    """wrap="auto" as the reference decides it (the JAX ConvGram2D's wrap
    and L, with its transfers, which this test does not read, left out);
    wrap=True on an image under 2 m - 1 raises; fft_shape sets the padded
    path's size and must cover n + 2 m - 2."""
    for name in ("make_wrap_cache", "make_pad_cache", "make_conv2d_gram_wrap"):
        monkeypatch.setattr(jgram, name, lambda *a, **k: None)
    h = rng.standard_normal((5, 5)).astype(np.float32)
    for shape in ((64, 64), (65, 64), (16, 64), (48, 20), (20, 20)):
        G = tconv.ConvGram2D(tconv.Convolve2D(shape, h, method="fft"))
        JG = jconv.ConvGram2D(jconv.Convolve2D(shape, jnp.asarray(h), method="fft"))
        assert G.wrap == JG.wrap and G.L == tuple(JG.L), shape
    assert tconv.ConvGram2D(tconv.Convolve2D((64, 64), h)).wrap
    assert not tconv.ConvGram2D(tconv.Convolve2D((64, 64), h), fft_shape=(72, 72)).wrap
    with pytest.raises(ValueError, match="wrap=True needs n >= 2m-1"):
        tconv.ConvGram2D(tconv.Convolve2D((16, 16), rng.standard_normal((9, 9))), wrap=True)
    with pytest.raises(ValueError, match="fft_shape"):
        tconv.ConvGram2D(tconv.Convolve2D((64, 64), h), fft_shape=(70, 72))
    A = tconv.Convolve2D((64, 64), h)
    x = _t(rng.standard_normal((64, 64)))
    _rel_close(tconv.ConvGram2D(A, fft_shape=(96, 81)).apply(x), A.gram.apply(x), 1e-5)


@pytest.mark.parametrize("kshape", [(5, 5), (4, 6), (3, 2)])
def test_direct_matches_jax(rng, kshape):
    """'direct' apply and adjoint (the VJP, at full f32) against the JAX
    'direct'; the dot test."""
    shape = (17, 13)
    h = rng.standard_normal(kshape).astype(np.float32)
    A = tconv.Convolve2D(shape, h, method="direct")
    J = jconv.Convolve2D(shape, jnp.asarray(h), method="direct")
    assert A.method == J.method == "direct" and A.lipschitz == J.lipschitz
    x, y = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(A.apply(_t(x)).numpy(), np.asarray(J.apply(jnp.asarray(x))), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(A.adjoint(_t(y)).numpy(), np.asarray(J.adjoint(jnp.asarray(y))), rtol=3e-4,
                               atol=3e-5)
    lhs, rhs = float(torch.sum(_t(y) * A.apply(_t(x)))), float(torch.sum(A.adjoint(_t(y)) * _t(x)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rank", [6, 9, 12, 15])
def test_bandg_matches_reference_sweeps(rng, rank):
    """'bandg' at 64 x 384: ceil(r/4) groups split as the reference splits
    them (the factor taps bit for bit), forward and adjoint against the
    reference's grouped plans summed through sepconv2d_sweep in interpret
    mode; the Gram is the composition A^H o A."""
    H, W = 64, 384
    filt = _lowrank_psf(rank, rank, 15)
    A = tconv.Convolve2D((H, W), filt, method="bandg")
    groups, r = jconv._grouped_sweep_plans(jnp.asarray(filt), (H, W))
    assert A.method == "bandg" and len(A.groups) == len(groups) == -(-rank // 4)
    us, vs = jconv.lowrank_factors(filt, max_rank=16)
    for i, (fwd, adj) in enumerate(A.groups):
        sl = slice(4 * i, min(4 * i + 4, rank))
        np.testing.assert_array_equal(fwd.u.numpy(), us[:, sl].astype(np.float32))
        np.testing.assert_array_equal(fwd.v.numpy(), vs[:, sl].astype(np.float32))
        assert adj.of is fwd
    x = rng.standard_normal((H, W)).astype(np.float32)
    y = sum(sepconv2d_sweep(jnp.asarray(x), B, C, r=r, interpret=True) for B, C, _, _ in groups)
    np.testing.assert_allclose(A.apply(_t(x)).numpy(), np.asarray(y), rtol=3e-4, atol=3e-5)
    aw = sum(sepconv2d_sweep(jnp.asarray(x), Ba, Ca, r=r, interpret=True) for _, _, Ba, Ca in groups)
    np.testing.assert_allclose(A.adjoint(_t(x)).numpy(), np.asarray(aw), rtol=3e-4, atol=3e-5)
    G = A.gram
    assert type(G).__name__ == "SymmetricLinearOperator"
    _rel_close(G.apply(_t(x)), A.adjoint(A.apply(_t(x))), 0.0)


def test_bandg_gates():
    """'bandg' with a rank-1 PSF raises; the groups exist for rank 5-16
    within 31 taps per axis only (what "auto" on a CUDA device takes), so a
    rank-17 PSF or one over 31 taps keeps 'fft' or 'direct'."""
    with pytest.raises(ValueError, match="bandg"):
        tconv.Convolve2D((32, 48), _lowrank_psf(0, 1, 7), method="bandg")
    plans = lambda h: tconv._grouped_sweep_plans(h, torch.device("cpu"))  # noqa: E731
    assert plans(_lowrank_psf(0, 4, 9)) is None
    assert len(plans(_lowrank_psf(0, 5, 9))) == 2
    assert len(plans(_lowrank_psf(0, 16, 31))) == 4
    assert plans(_fullrank_psf(0, 17)) is None  # rank 17
    assert plans(_lowrank_psf(0, 6, 33, 5)) is None  # 33 row taps
    assert len(plans(_fullrank_psf(7, 15))) == 4  # bench.py's full-rank PSF has rank 15


@pytest.mark.parametrize("name", ["gauss", "rank2", "rank6", "fullrank5", "fullrank9", "fullrank10x9", "identity"])
def test_auto_picks_the_reference_cpu_method(name):
    """On the CPU "auto" takes what the reference takes on its CPU backend:
    'band' for rank <= 4, else 'direct' within 81 taps, else 'fft'."""
    ax = np.arange(7) - 3
    psf = {
        "gauss": np.outer(np.exp(-ax**2 / 4.0), np.exp(-ax**2 / 4.0)),
        "rank2": _lowrank_psf(1, 2, 7),
        "rank6": _lowrank_psf(1, 6, 15),
        "fullrank5": _fullrank_psf(2, 5),
        "fullrank9": _fullrank_psf(3, 9),
        "fullrank10x9": _fullrank_psf(4, 10)[:, :9],
        "identity": np.ones((1, 1)),
    }[name].astype(np.float32)
    A = tconv.Convolve2D((48, 40), psf)
    J = jconv.Convolve2D((48, 40), jnp.asarray(psf))
    assert A.method == J.method


@pytest.mark.parametrize("tol", [None, 1e-3, 0.2])
def test_svd_tol_matches_reference(rng, tol):
    """svd_tol: the truncated PSF and svd_trunc_bound equal the reference's;
    the operator is the truncated PSF (apply against the JAX one)."""
    h = (_lowrank_psf(5, 2, 9) + 1e-4 * rng.standard_normal((9, 9))).astype(np.float32)
    shape = (24, 32)
    A = tconv.Convolve2D(shape, h, svd_tol=tol)
    J = jconv.Convolve2D(shape, jnp.asarray(h), svd_tol=tol)
    np.testing.assert_array_equal(A.filt.numpy(), np.asarray(J.filt))
    assert A.svd_trunc_bound == J.svd_trunc_bound
    assert A.method == J.method and A.lipschitz == J.lipschitz
    assert (A.svd_trunc_bound == 0.0) == (tol is None)
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(A.apply(_t(x)).numpy(), np.asarray(J.apply(jnp.asarray(x))), rtol=3e-4, atol=3e-5)


# -- TVDeconvolution on PSFs outside the band gate ------------------------------


def _assert_iterates_close(tstate, jstate):
    scale = float(np.abs(np.asarray(jstate["x"])).max())
    for k in ("x", "z0", "z1"):
        np.testing.assert_allclose(
            tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-4, atol=1e-5 * scale, err_msg=k
        )


PSFS = {"rank6": _lowrank_psf(11, 6, 11), "fullrank": _fullrank_psf(7, 7)}


def _problem(rng, h, shape):
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y = np.asarray(jconv.Convolve2D(shape, jnp.asarray(h)).apply(jnp.asarray(x_true)))
    return (y + 0.01 * rng.standard_normal(shape)).astype(np.float32)


_JAX_RUNS = {}


def _jax_run(psf, shape, mask: bool):
    """``(y, keep, state)``: the problem and the JAX TVDeconvolution's state
    after 6 iterations, made once per (psf, shape, mask) in this module (the
    JAX PDS fuses onto the same solver)."""
    key = (psf, shape, mask)
    if key not in _JAX_RUNS:
        h = PSFS[psf]
        y = _problem(np.random.default_rng(29), h, shape)
        keep = (np.random.default_rng(13).random(shape) < 0.7) if mask else None
        j = jopt.TVDeconvolution(shape, jnp.asarray(y if keep is None else y * keep), LAM, filt=h,
                                 mask=None if keep is None else jnp.asarray(keep, jnp.float32), max_iter=100)
        _JAX_RUNS[key] = (y, keep, j.tau, j.run_fixed(6))
    return _JAX_RUNS[key]


def _torch_tv(h, y, shape, route, keep=None):
    """The port's solver, built directly or through PDS fusion of
    ``SquaredL2Loss * [Masking *] Convolve2D``."""
    if route == "direct":
        m = None if keep is None else keep.astype(np.float32)
        return topt.TVDeconvolution(shape, y if keep is None else y * m, LAM, filt=h, mask=m, max_iter=100)
    A = tops.Convolve2D(shape, h)
    if keep is not None:
        A, y = tops.Masking(shape, keep) * A, y[keep]
    p = topt.PDS(shape, F=tfunc.SquaredL2Loss(A.codim_shape, data=y) * A, G=tfunc.NonNegativeOrthant(shape),
                 H=LAM * tfunc.L21Norm((2,) + shape, axis=0), K=tops.Gradient(shape), max_iter=100)
    assert type(p._fused) is topt.TVDeconvolution
    return p


@pytest.mark.parametrize("psf,shape,route", [
    ("rank6", (48, 64), "direct"), ("rank6", (48, 64), "pds"), ("rank6", (40, 56), "direct"),
    ("fullrank", (48, 64), "direct"), ("fullrank", (48, 64), "pds"),
])
def test_tv_other_psfs_match_jax(psf, shape, route):
    """Conv mode with a rank-6 (11 x 11: 'fft') and a full-rank (7 x 7:
    'direct') PSF, built directly and through PDS fusion: the FFT Gram
    (wrap at 48 x 64, padded at 40 x 56) and the plain engine's K3 plain
    version, against the JAX solver after 6 iterations."""
    y, _, tau, js = _jax_run(psf, shape, mask=False)
    t = _torch_tv(PSFS[psf], y, shape, route)
    tv = t if route == "direct" else t._fused
    assert tv.mode == "conv" and tv.stencil_mode == "plain" and type(tv.gram) is tops.ConvGram2D
    assert tv.gram.wrap == (shape == (48, 64))
    assert t.tau == tau
    _assert_iterates_close(t.run_fixed(6), js)


def test_tv_bandg_gram_matches_jax():
    """The card's rank-6 route on the CPU: the solver's Gram swapped for a
    'bandg' convolution's composition (two groups of K1's plain version each
    way), against the JAX solver after 6 iterations."""
    shape = (48, 64)
    y, _, _, js = _jax_run("rank6", shape, mask=False)
    t = _torch_tv(PSFS["rank6"], y, shape, "direct")
    t.gram = tconv.Convolve2D(shape, PSFS["rank6"], method="bandg").gram
    _assert_iterates_close(t.run_fixed(6), js)


@pytest.mark.parametrize("route", ["direct", "pds"])
def test_tv_combined_fullrank_matches_jax(route):
    """Combined mode (blur + mask) with a full-rank PSF, directly and
    through PDS fusion of ``Masking * Convolve2D``: the gradient 2 (C^H (m
    C x) - atb) into K3's plain version, where the reference runs its XLA
    chain; the JAX solver's iterates after 6 iterations."""
    shape = (48, 64)
    y, keep, tau, js = _jax_run("fullrank", shape, mask=True)
    t = _torch_tv(PSFS["fullrank"], y, shape, route, keep=keep)
    tv = t if route == "direct" else t._fused
    assert (tv.mode, tv.stencil_mode, tv.conv.method) == ("combined", "plain", "direct")
    assert t.tau == tau
    _assert_iterates_close(t.run_fixed(6), js)


def test_engines_for_other_psfs():
    """On a CUDA device "auto" takes sweep for an FFT Gram and for a 'bandg'
    composition, megar only for a band Gram; an explicit megar or rank-1
    engine raises for them; combined mode takes sweep where megarm does not
    apply, and an explicit megarm raises."""
    shape = (64, 64)
    fft_gram = tconv.Convolve2D(shape, PSFS["fullrank"]).gram
    bandg_gram = tconv.Convolve2D(shape, PSFS["rank6"], method="bandg").gram
    band_gram = tconv.Convolve2D(shape, _lowrank_psf(0, 2, 7)).gram
    for g in (fft_gram, bandg_gram):
        assert conv_engine(g, "auto", "cuda") == "sweep"
        assert conv_engine(g, "element", "cuda") == "element"
        assert conv_engine(g, "auto", "cpu") == "plain"
        for e in ("megar", "mega3", "mega2", "mega"):
            with pytest.raises(ValueError, match="not eligible"):
                conv_engine(g, e, "cuda")
    assert conv_engine(band_gram, "auto", "cuda") == "megar"
    full = tconv.Convolve2D(shape, PSFS["fullrank"])
    band = tconv.Convolve2D(shape, _lowrank_psf(0, 2, 7))
    assert masked_engine("combined", "auto", "cuda", conv=full) == "sweep"
    assert masked_engine("combined", "auto", "cuda", conv=band) == "megarm"
    assert masked_engine("combined", "sweep", "cuda", conv=band) == "sweep"
    with pytest.raises(ValueError, match="megarm"):
        masked_engine("combined", "megarm", "cuda", conv=full)
