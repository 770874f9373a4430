"""The rank-1 TV slice of the port against the JAX package, on the CPU.

* ``kernels/band.py`` and ``SeparableConvGram2D``'s rank-1 plan: bit-equal
  to the reference's; the plain band passes within 1e-6.
* K10-K13 (mega3, mega2, mega, element): each wrapper's CPU route (its
  plain version) against the Pallas kernel in interpret mode on the
  reference's own shapes, nonneg on and off, iso and aniso: rtol 3e-5 /
  atol 3e-6 for one launch (the reference's own, tests/test_kernels.py),
  rtol 1e-4 / atol 1e-5 after 5 launches, and mega3's metric partial sums
  (second iteration only) within rtol 1e-3.
* ``TVDeconvolution`` on each rank-1 engine against the JAX solver (xla)
  after 6 iterations, the small-denoise route, the double-step
  bookkeeping of mega3 against the reference's mega3 engine, and the
  engine ladder against the JAX solver's pick.
* The device rule: numpy-only inputs with no ``device=`` raise without
  CUDA, naming ``device="cpu"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.ops.conv as jconv
import pycsou_tpu.ops.diff as jdiff
import pycsou_tpu.opt as jopt
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
from pycsou_tpu.kernels.band import gram_band_cols as jax_band_cols
from pycsou_tpu.kernels.band import gram_band_rows as jax_band_rows
from pycsou_tpu.kernels.band import make_gram_band as jax_make_gram_band
from pycsou_tpu.kernels.tv import (
    make_mega2_lane_plan,
    make_mega3_corr_mats,
    make_mega_band,
    tv_pds_stencil_step_xla,
)
from pycsou_tpu_torch.kernels.band import gram_band_cols, gram_band_rows, make_gram_band
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_mega2_step,
    tv_pds_mega3_step,
    tv_pds_mega_step,
    tv_pds_stencil_step,
)
from pycsou_tpu_torch.opt.tv import conv_engine, rank1_gate
from pycsou_tpu_torch.utils.convert import state_from_numpy
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


LAM = 0.05
KW = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.05)


def _psf(k0, k1=None, s0=2.0, s1=1.3):
    """A rank-1 Gaussian PSF of k0 x k1 taps (1 x 1: the identity)."""
    k1 = k0 if k1 is None else k1
    a0, a1 = np.arange(k0) - k0 // 2, np.arange(k1) - k1 // 2
    h = np.outer(np.exp(-(a0**2) / (2 * s0**2)), np.exp(-(a1**2) / (2 * s1**2)))
    return (h / h.sum()).astype(np.float32)


def _rank2(k=9):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h = np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))
    return (h / h.sum()).astype(np.float32)


def _grams(shape, h):
    """(JAX Gram, port Gram) of the same PSF."""
    return jconv.Convolve2D(shape, jnp.asarray(h)).gram, tops.Convolve2D(shape, h).gram


def _inputs(rng, shape):
    """x, z (2, H, W) with the dual invariant, atb: numpy, seeded."""
    x = rng.standard_normal(shape).astype(np.float32)
    z = (0.1 * rng.standard_normal((2,) + shape)).astype(np.float32)
    z[0, -1] = 0.0
    z[1, :, -1] = 0.0
    atb = rng.standard_normal(shape).astype(np.float32)
    return x, z, atb


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


# -- the band and the rank-1 plan ------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 4, 9, 15])
def test_make_gram_band_bit_equal(rng, K):
    taps = rng.standard_normal(K)
    acorr, Et, Eb, L = make_gram_band(taps, 3 * K + 5)
    _, jEt, jEb, jL = jax_make_gram_band(taps, 3 * K + 5)
    assert L == jL
    assert acorr.dtype == np.float64 and np.array_equal(acorr, np.convolve(taps, taps[::-1]))
    if K == 1:
        assert Et is None and jEt is None and Eb is None and jEb is None
    else:
        assert Et.dtype == np.float32 and np.array_equal(Et, jEt) and np.array_equal(Eb, jEb)
    with pytest.raises(ValueError):
        if K > 1:
            make_gram_band(taps, 3 * K - 1)
        else:
            raise ValueError


@pytest.mark.parametrize("shape,h", [
    ((64, 384), _psf(15)), ((48, 64), _psf(9, 5)), ((20, 33), _psf(1)), ((50, 64), _psf(16, 3)),
    ((40, 64), _psf(15)), ((64, 96), _rank2()),
], ids=["gauss15", "9x5", "identity", "16x3", "too-short", "rank2"])
def test_rank1_plan_fields_bit_equal(shape, h):
    jg, tg = _grams(shape, h)
    assert (jg.g_meta is None) == (tg.g_meta is None)
    if tg.g_meta is None:
        return
    assert tg.g_meta == jg.g_meta
    for name in ("g_rows_acorr", "g_cols_acorr", "g_rows_taps", "g_cols_taps"):
        assert getattr(tg, name) == getattr(jg, name), name
    for name in ("g_rows_E", "g_cols_E"):
        te, je = getattr(tg, name), getattr(jg, name)
        assert (te is None) == (je is None)
        for a, b in zip(te or (), je or ()):
            assert np.array_equal(a.numpy(), np.asarray(b)), name


@pytest.mark.parametrize("shape,h", [((64, 384), _psf(15)), ((48, 64), _psf(9, 5)), ((20, 33), _psf(1))],
                         ids=["gauss15", "9x5", "identity"])
def test_gram_band_passes_match_jax(rng, shape, h):
    jg, tg = _grams(shape, h)
    x = rng.standard_normal(shape).astype(np.float32)
    rows, cols = tg.band_plans()
    lr, L_r, lc, L_c = jg.g_meta

    def jplan(band, lead, E, L):
        return ((band[0], band[1], lead), *(E or (None, None)), L)

    tx = torch.from_numpy(x)
    jr = jax_band_rows(jnp.asarray(x), jplan(jg.g_rows_band, lr, jg.g_rows_E, L_r))
    jc = jax_band_cols(jnp.asarray(x), jplan(jg.g_cols_band, lc, jg.g_cols_E, L_c))
    scale = float(np.abs(np.asarray(jr)).max())
    _close(gram_band_rows(tx, rows), jr, 1e-6, 1e-6 * scale)
    _close(gram_band_cols(tx, cols), jc, 1e-6, 1e-6 * scale)
    full = gram_band_rows(gram_band_cols(tx, cols), rows)
    _close(full, jg.apply(jnp.asarray(x)), 1e-6, 1e-6 * scale)
    _close(full, tg.apply(tx), 1e-5, 1e-6 * scale)  # the K2 form of the same Gram


# -- K10-K13: plain versions against the Pallas kernels (interpret mode) ----

_MODES = [(True, True), (False, False)]  # (nonneg, iso)


def _jax_mega2_corr(jg, x):
    solver = jopt.TVDeconvolution.__new__(jopt.TVDeconvolution)
    solver.gram = jg
    return jopt.TVDeconvolution._mega2_corr(solver, x)


@pytest.mark.parametrize("K", [15, 9, 4, 1])
@pytest.mark.parametrize("nonneg,iso", _MODES)
def test_mega3_plain_matches_pallas(rng, K, nonneg, iso):
    from pycsou_tpu.kernels.tv import tv_pds_mega3_step as jax_mega3

    shape = (64, 384)
    h = _psf(K, K, 2.0, 1.3)
    jg, tg = _grams(shape, h)
    B = jnp.asarray(make_mega_band(jg.g_rows_acorr, r=32))
    C, F = make_mega2_lane_plan(jg.g_cols_taps, shape[1])
    Et, Eb = make_mega3_corr_mats(jg.g_rows_E, jg.g_meta[1])
    x, z, atb = _inputs(rng, shape)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jx, jz0, jz1, jst = jax_mega3(*(jnp.asarray(a) for a in (x, z[0], z[1], atb)), B, jnp.asarray(C),
                                  jnp.asarray(F), jnp.asarray(Et), jnp.asarray(Eb), interpret=True, **kw)
    tx, tz0, tz1, tst = tv_pds_mega3_step(*(torch.from_numpy(a) for a in (x, z[0], z[1], atb)), tg, **kw)
    for k, (a, b) in {"x": (tx, jx), "z0": (tz0, jz0), "z1": (tz1, jz1)}.items():
        _close(a, b, 3e-5, 3e-6, k)
    # the partial sums of the second iteration only (its "old" is the first's output)
    _close(tst, np.asarray(jst)[0, :6], 1e-3, 1e-6)


@pytest.mark.parametrize("shape,K", [((64, 384), 15), ((32, 512), 9), ((128, 384), 5), ((64, 384), 4)])
@pytest.mark.parametrize("nonneg,iso", _MODES)
def test_mega2_plain_matches_pallas(rng, shape, K, nonneg, iso):
    from pycsou_tpu.kernels.tv import tv_pds_mega2_step as jax_mega2

    jg, tg = _grams(shape, _psf(K))
    B = jnp.asarray(make_mega_band(jg.g_rows_acorr))
    C, F = make_mega2_lane_plan(jg.g_cols_taps, shape[1])
    x, z, atb = _inputs(rng, shape)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jx = jnp.asarray(x)
    jo = jax_mega2(jx, jnp.asarray(z[0]), jnp.asarray(z[1]), jnp.asarray(atb), _jax_mega2_corr(jg, jx), B,
                   jnp.asarray(C), jnp.asarray(F), interpret=True, **kw)
    to = tv_pds_mega2_step(*(torch.from_numpy(a) for a in (x, z[0], z[1], atb)), tg, **kw)
    for k, a, b in zip(("x", "z0", "z1"), to[:3], jo[:3]):
        _close(a, b, 3e-5, 3e-6, k)
    _close(to[3], np.asarray(jo[3])[0, :6], 1e-4, 1e-6)


@pytest.mark.parametrize("shape,K", [((128, 160), 15), ((96, 128), 9), ((64, 256), 15), ((128, 128), 5)])
@pytest.mark.parametrize("nonneg,iso", _MODES)
def test_mega_plain_matches_pallas(rng, shape, K, nonneg, iso):
    """K12 from the port's own w = ColGram(x) (``_mega_colgram``) against
    the Pallas kernel from the reference's w and corrections."""
    from pycsou_tpu.kernels.tv import tv_pds_mega_step as jax_mega

    h = _psf(K)
    jg, _ = _grams(shape, h)
    x, z, atb = _inputs(rng, shape)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jsolver = jopt.TVDeconvolution.__new__(jopt.TVDeconvolution)
    jsolver.gram = jg
    w, corr = jopt.TVDeconvolution._mega_colgram(jsolver, jnp.asarray(x))
    jx, jz = jax_mega(jnp.asarray(x), jnp.asarray(z), w, jnp.asarray(atb), corr,
                      jnp.asarray(make_mega_band(jg.g_rows_acorr)), interpret=True, **kw)
    solver = topt.TVDeconvolution(shape, atb, LAM, filt=h)
    tx = torch.from_numpy(x)
    tw = solver._mega_colgram(tx)
    _close(tw, w, 1e-5, 1e-6)
    gx, gz = tv_pds_mega_step(tx, torch.from_numpy(z), tw, torch.from_numpy(atb), solver.gram, **kw)
    _close(gx, jx, 3e-5, 3e-6, "x")
    _close(gz, jz, 3e-5, 3e-6, "z")


@pytest.mark.parametrize("shape", [(64, 96), (40, 128)])
@pytest.mark.parametrize("nonneg,iso", _MODES)
def test_element_plain_matches_pallas(rng, shape, nonneg, iso):
    from pycsou_tpu.kernels.tv import tv_pds_stencil_step as jax_element

    x, z, g = _inputs(rng, shape)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jx, jz = jax_element(jnp.asarray(x), jnp.asarray(z), jnp.asarray(g), interpret=True, **kw)
    tx, tz = tv_pds_stencil_step(*(torch.from_numpy(a) for a in (x, z, g)), **kw)
    _close(tx, jx, 3e-5, 3e-6, "x")
    _close(tz, jz, 3e-5, 3e-6, "z")


@pytest.mark.parametrize("engine", ["mega3", "mega2", "mega"])
def test_rank1_launches_iterated(rng, engine):
    """5 launches of each rank-1 engine's CPU route track the reference's
    XLA oracle (its Gram, then tv_pds_stencil_step_xla) through real
    dynamics: rtol 1e-4 / atol 1e-5."""
    shape = (96, 384)
    jg, tg = _grams(shape, _psf(15))
    atb = rng.standard_normal(shape).astype(np.float32)
    kw = dict(tau=0.1, sigma=0.1, rho=0.9, lam=0.05, nonneg=True)
    tatb = torch.from_numpy(atb)
    tx = torch.zeros(shape)
    tz = torch.zeros((2,) + shape)
    solver = topt.TVDeconvolution(shape, atb, LAM, filt=_psf(15))
    n_oracle = 0
    for _ in range(5):
        if engine == "mega":
            tx, tz = tv_pds_mega_step(tx, tz, solver._mega_colgram(tx), tatb, tg, **kw)
            n_oracle += 1
        else:
            step = tv_pds_mega3_step if engine == "mega3" else tv_pds_mega2_step
            tx, z0, z1, _ = step(tx, tz[0].contiguous(), tz[1].contiguous(), tatb, tg, **kw)
            tz = torch.stack([z0, z1])
            n_oracle += 2 if engine == "mega3" else 1
    jx, jz = jnp.zeros(shape), jnp.zeros((2,) + shape)
    for _ in range(n_oracle):
        jx, jz = tv_pds_stencil_step_xla(jx, jz, 2.0 * (jg.apply(jx) - jnp.asarray(atb)), **kw)
    _close(tx, jx, 1e-4, 1e-5, "x")
    _close(tz, jz, 1e-4, 1e-5, "z")


def test_rank1_wrappers_check_their_inputs(rng):
    shape = (48, 64)
    _, tg = _grams(shape, _psf(9))
    x, z, atb = (torch.from_numpy(a) for a in _inputs(rng, shape))
    with pytest.raises(ValueError, match="rank-1 plan"):
        tv_pds_mega2_step(x, z[0], z[1], atb, _grams(shape, _rank2())[1], **KW)
    with pytest.raises(ValueError, match="gram"):
        tv_pds_mega3_step(x[:32], z[0][:32], z[1][:32], atb[:32], tg, **KW)
    with pytest.raises(ValueError, match="z"):
        tv_pds_stencil_step(x, z[0], atb, **KW)
    with pytest.raises(ValueError, match="taps per axis"):
        tv_pds_mega2_step(*(t for t in (x, z[0], z[1], atb)), _grams((60, 80), _psf(5, 17))[1], **KW)


# -- the solver ------------------------------------------------------------


def _problem(rng, shape, h):
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y = np.asarray(jconv.Convolve2D(shape, jnp.asarray(h)).apply(jnp.asarray(x_true)))
    return (y + 0.01 * rng.standard_normal(shape)).astype(np.float32)


def _assert_iterates_close(ts, js, rtol=1e-4):
    scale = float(np.abs(np.asarray(js["x"])).max())
    for k in ("x", "z0", "z1"):
        _close(ts[k], js[k], rtol, 1e-5 * scale, k)


def _on_engine(solver, engine):
    """The port refuses a CUDA engine on a CPU device; switched over with
    ``replace``, the solver runs that engine's wrappers on CPU tensors (their
    plain versions)."""
    return solver.replace(stencil_mode=engine, iters_per_step=2 if engine == "mega3" else 1)


@pytest.mark.parametrize("engine", ["mega3", "mega2", "mega", "element"])
def test_solver_engines_match_jax(rng, engine):
    shape, h = (64, 96), _psf(9)
    y = _problem(rng, shape, h)
    j = jopt.TVDeconvolution(shape, jnp.asarray(y), LAM, filt=h, max_iter=100)
    t = topt.TVDeconvolution(shape, y, LAM, filt=h, max_iter=100)
    assert j.stencil_mode == "xla" and t.stencil_mode == "plain"
    assert conv_engine(t.gram, "auto", "cuda") == "mega3"
    t = _on_engine(t, engine)
    ts, js = t.run_fixed(6), j.run_fixed(6)
    assert ts["it"] == int(js["it"]) == 6
    assert ("_stats" in ts) == (engine in ("mega3", "mega2"))
    _assert_iterates_close(ts, js)
    rows = slice(1, 6, 2) if engine == "mega3" else slice(0, 6)  # mega3 measures every second row
    _close(ts["history"][rows], np.asarray(js["history"])[rows], 1e-3, 1e-7)
    if engine == "mega3":
        assert np.isnan(ts["history"][0:6:2].numpy()).all()


@pytest.mark.parametrize("engine", ["mega", "element"])
def test_jax_state_continues_on_engine(rng, engine):
    """A JAX state (the mega/element layout: no ``_stats``) carried into
    the port through numpy continues on that engine as the JAX solver does."""
    shape, h = (64, 96), _psf(9)
    y = _problem(rng, shape, h)
    j = jopt.TVDeconvolution(shape, jnp.asarray(y), LAM, filt=h, max_iter=100)
    warm = j.run_fixed(4)
    tstate = state_from_numpy({k: np.asarray(v) for k, v in warm.items()}, "cpu")
    assert "_stats" not in tstate and tstate["it"] == 4
    t = _on_engine(topt.TVDeconvolution(shape, y, LAM, filt=h, max_iter=100), engine)
    ts, js = t.run_fixed(4, state=tstate), j.run_fixed(4, state=warm)
    assert ts["it"] == int(js["it"]) == 8
    _assert_iterates_close(ts, js)


def test_small_denoise_route(rng):
    """PDS on a small denoising problem (filt None, < 2**21 pixels) fuses
    onto the conv mode's identity 1 x 1 PSF; its CUDA pick is mega3, and
    the mega3 engine's CPU route matches the JAX solver."""
    shape = (64, 96)
    y = np.abs(rng.standard_normal(shape)).astype(np.float32)
    H = LAM * tfunc.L21Norm((2,) + shape, axis=0)
    tp = topt.PDS(shape, F=tfunc.SquaredL2Loss(shape, data=y), G=tfunc.NonNegativeOrthant(shape), H=H,
                  K=tops.Gradient(shape), max_iter=100)
    jp = jopt.PDS(shape, F=jfunc.SquaredL2Loss(shape, data=jnp.asarray(y)), G=jfunc.NonNegativeOrthant(shape),
                  H=LAM * jpen.L21Norm((2,) + shape, axis=0), K=jdiff.Gradient(shape), max_iter=100)
    fused = tp._fused
    assert fused.mode == "conv" and tuple(fused.filt.shape) == (1, 1) and fused.stencil_mode == "plain"
    assert rank1_gate(fused.gram) is None and conv_engine(fused.gram, "auto", "cuda") == "mega3"
    ts, js = tp.run_fixed(6), jp.run_fixed(6)
    _assert_iterates_close(ts, js)
    ms = _on_engine(fused, "mega3").run_fixed(6)
    _assert_iterates_close(ms, js)


def test_mega3_bookkeeping_matches_reference(rng, monkeypatch):
    """The double step against the reference's mega3 engine (interpret
    mode): run_fixed(odd n) runs n + 1 iterations, the odd history rows
    stay NaN, and iterates and measured rows agree."""
    import pycsou_tpu.opt.tv as jtv_opt

    real = jtv_opt.tv_pds_mega3_step
    monkeypatch.setattr(jtv_opt, "tv_pds_mega3_step", lambda *a, **k: real(*a, interpret=True, **k))
    shape, h = (64, 384), _psf(15)
    y = _problem(rng, shape, h)
    j = jopt.TVDeconvolution(shape, jnp.asarray(y), LAM, filt=h, use_pallas=True, max_iter=60)
    t = topt.TVDeconvolution(shape, y, LAM, filt=h, max_iter=60)
    with pytest.raises(ValueError, match="CUDA"):
        topt.TVDeconvolution(shape, y, LAM, filt=h, stencil="mega3")
    t = _on_engine(t, "mega3")
    assert j.stencil_mode == "mega3" and j.iters_per_step == t.iters_per_step == 2
    n0 = tv_pds_mega3_step.launches
    js, ts = j.run_fixed(5), t.run_fixed(5)
    assert ts["it"] == int(js["it"]) == 6
    assert tv_pds_mega3_step.launches == n0  # CPU tensors: no launch
    _assert_iterates_close(ts, js)
    th, jh = ts["history"][:6].numpy(), np.asarray(js["history"])[:6]
    assert np.isnan(th[0::2]).all() and np.isnan(jh[0::2]).all()
    _close(th[1::2], jh[1::2], 1e-3, 1e-7)


# -- the ladder ------------------------------------------------------------

_SHAPES = [(64, 384), (96, 512), (100, 384), (64, 200), (48, 1000), (64, 4352), (40, 64)]
_PSFS = {"gauss15": _psf(15), "gauss9": _psf(9), "identity": _psf(1), "5x21": _psf(5, 21), "rank2": _rank2()}


def _reference_tiles_ok(shape):
    """The reference's TPU tile and VMEM gates of mega3 (opt/tv.py:72)."""
    H, W = shape
    return H % 32 == 0 and H // 32 >= 2 and W % 128 == 0 and W >= 384 and 48 * W * 4 <= 820_000


@pytest.mark.parametrize("psf", sorted(_PSFS))
def test_ladder_matches_reference_pick(psf):
    """The port's CUDA pick for each (shape, PSF) against the JAX solver's
    (``use_pallas=True`` on the CPU selects without launching).  They differ
    only where ``rank1_gate``'s docstring says: the reference's TPU tile
    gates (the port's mega3 tiles any shape, the reference falls down its
    ladder), and rank-1 PSFs of more than 16 columns (megar here)."""
    h = _PSFS[psf]
    for shape in _SHAPES:
        y = np.zeros(shape, np.float32)
        t = topt.TVDeconvolution(shape, y, LAM, filt=h)
        port = conv_engine(t.gram, "auto", "cuda")
        ref = jopt.TVDeconvolution(shape, jnp.asarray(y), LAM, filt=h, use_pallas=True).stencil_mode
        eligible = rank1_gate(t.gram) is None
        assert port == ("mega3" if eligible else "megar"), (shape, psf)
        if eligible and _reference_tiles_ok(shape):
            assert ref == port, (shape, psf)
        elif psf == "5x21" and _reference_tiles_ok(shape):
            assert ref == "mega3" and "column" in rank1_gate(t.gram), shape
        else:
            assert ref != "mega3" or not eligible, (shape, psf, ref)


def test_explicit_engines_are_honoured_or_raise(rng):
    shape = (48, 64)
    y = rng.standard_normal(shape).astype(np.float32)
    g1 = tops.Convolve2D(shape, _psf(9)).gram
    g2 = tops.Convolve2D(shape, _rank2()).gram
    for e in ("mega3", "mega2", "megar", "mega", "sweep", "element"):
        assert conv_engine(g1, e, "cuda") == e
    for e in ("mega3", "mega2", "mega"):
        with pytest.raises(ValueError, match="not eligible"):
            conv_engine(g2, e, "cuda")
        with pytest.raises(ValueError, match="not eligible"):
            topt.TVDeconvolution(shape, y, LAM, filt=_rank2(), stencil=e)
    assert conv_engine(g2, "auto", "cuda") == "megar"
    assert conv_engine(g1, "auto", "cpu") == "plain"
    with pytest.raises(ValueError, match="CPU tensors only"):
        conv_engine(g1, "plain", "cuda")
    with pytest.raises(ValueError, match="conv mode supports"):
        conv_engine(g1, "sweepm2", "cuda")


def test_pmyula_gate_is_the_rank1_gate(rng):
    """PMYULA's fused engine applies exactly where rank1_gate passes."""
    shape = (48, 64)
    y = torch.zeros(shape)
    for h in (_psf(9), _psf(1), _psf(15), _psf(5, 17), _psf(17, 3), _rank2()):
        F = tfunc.SquaredL2Loss(shape, data=y) * tops.Convolve2D(shape, h)
        s = topt.PMYULA(shape, F=F)
        assert s.engine == ""  # auto on the CPU: the generic chain
        ok = rank1_gate(tops.Convolve2D(shape, h).gram) is None
        if ok:
            assert topt.PMYULA(shape, F=F, use_pallas="interpret").engine == "megal"
        else:
            with pytest.raises(ValueError, match="rank-1 engines' gate"):
                topt.PMYULA(shape, F=F, use_pallas="interpret")


# -- the device rule ---------------------------------------------------------


_ENTRY_POINTS = {
    "Convolve2D": lambda: tops.Convolve2D((64, 64), np.ones((3, 3))),
    "SquaredL2Loss": lambda: tfunc.SquaredL2Loss((8, 8), data=np.ones((8, 8), np.float32)),
    "TVDeconvolution": lambda: topt.TVDeconvolution((48, 64), np.zeros((48, 64), np.float32), LAM),
    "LassoDeconvolution": lambda: topt.LassoDeconvolution((48, 64), np.zeros((48, 64), np.float32), 0.01,
                                                          filt=_psf(5)),
    "Masking": lambda: tops.Masking((8, 8), np.ones((8, 8), bool)),
    "SubSampling": lambda: tops.SubSampling((8, 8), np.arange(4)),
    "state_from_numpy": lambda: state_from_numpy({"x": np.zeros(3, np.float32)}, None),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_numpy_inputs_run_on_the_card_or_raise(entry):
    """With numpy inputs and no device=, an entry point takes the CUDA card;
    without CUDA it raises and names device="cpu".  Asked for the CPU (the
    port's default set to it), it builds there."""
    set_default_device(None)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the entry point would run there")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _ENTRY_POINTS[entry]()
    set_default_device("cpu")
    _ENTRY_POINTS[entry]()


def test_cpu_tensors_and_device_cpu_ask_for_the_cpu():
    set_default_device(None)
    c = tops.Convolve2D((64, 64), torch.ones((3, 3)))
    assert c.device.type == "cpu"
    c = tops.Convolve2D((64, 64), np.ones((3, 3)), device="cpu")
    assert c.device.type == "cpu" and c.apply(torch.ones((64, 64))).device.type == "cpu"
    t = topt.TVDeconvolution((48, 64), torch.zeros((48, 64)), LAM, filt=_psf(5))
    assert t.device.type == "cpu" and t.stencil_mode == "plain"
