"""The masked TV slice of the port on the CPU against the JAX package:
the sampling operators, the plain versions of K5 (sweepm), K6 (sweepm2)
and K7 (megarm) against the Pallas kernels in interpret mode, and the
inpainting, super-resolution, large-denoise and Chambolle-Pock paths
through the user's entry points.

Tolerances, each with its reason:

* kernels, the JAX tests' own (``tests/test_masked_tv.py``): sweepm rtol
  3e-5 / atol 3e-6 (the same f32 stencil arithmetic); sweepm2 over two
  double steps rtol 1e-4 / atol 1e-5 (two iterations compound the
  rounding); megarm over three steps rtol 3e-4 / atol 3e-5 (the TPU
  kernel's bf16x3 dots against f32 convolutions); metric partial sums rtol
  1e-3 (another summation order);
* the solvers after 20 iterations: rtol 1e-4 and atol 1e-5 * max|x| (the
  two packages sum the convolutions in different orders);
* the sampling operators: exact for gathers, 1e-6 relative for the
  back-projection of repeated SubSampling indices (the scatter adds in
  another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.ops.conv as jconv
import pycsou_tpu.ops.diff as jdiff
import pycsou_tpu.ops.sampling as jsamp
import pycsou_tpu.opt as jopt
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
from pycsou_tpu.kernels.tvr import make_megar_plan
from pycsou_tpu.ops.conv import lowrank_factors
from pycsou_tpu_torch.kernels.conv2d import SepFactors
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_sweepm2_step,
    tv_pds_sweepm2_step_plain,
    tv_pds_sweepm_step_stats,
    tv_pds_sweepm_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tvr import tv_pds_megar_step, tv_pds_megarm_step, tv_pds_megarm_step_plain
from pycsou_tpu_torch.utils.convert import state_from_numpy

S = (48, 64)
LAM = 0.05


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _gauss(k=5, s=1.0):
    g = np.exp(-((np.arange(k) - k // 2) ** 2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _rank2(k=7):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h = np.outer(g(1.5), g(1.5)) + 0.35 * np.outer(g(0.8), g(3.0))
    return (h / h.sum()).astype(np.float32)


# -- kernels: plain versions against the Pallas kernels (interpret mode) -----


@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("nonneg", [True, False])
def test_sweepm_plain_matches_pallas(rng, iso, nonneg):
    from pycsou_tpu.kernels.tv import tv_pds_sweepm_step_stats as jax_sweepm

    H, W = 64, 256
    kw = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.05, nonneg=nonneg, iso=iso)
    x = rng.standard_normal((H, W)).astype(np.float32)
    z = (rng.standard_normal((2, H, W)) * 0.1).astype(np.float32)
    z[0, -1] = 0.0
    z[1, :, -1] = 0.0
    m = (rng.random((H, W)) < 0.4).astype(np.float32)
    atb = m * rng.standard_normal((H, W)).astype(np.float32)
    want = jax_sweepm(*(jnp.asarray(a) for a in (x, z[0], z[1], m, atb)), interpret=True, **kw)
    got = tv_pds_sweepm_step_stats_plain(*(_t(a) for a in (x, z[0], z[1], m, atb)), **kw)
    for i in range(3):
        _close(got[i], want[i], 3e-5, 3e-6)
    _close(got[3], np.asarray(want[3])[0, :6], 1e-3, 1e-7)


@pytest.mark.parametrize("iso", [True, False])
def test_sweepm2_plain_matches_pallas(rng, iso):
    """Two double steps chained (the TPU kernel's ring coverage); the stats
    measure the second iteration of each."""
    from pycsou_tpu.kernels.tv import tv_pds_sweepm2_step as jax_sweepm2

    H, W = 96, 256
    kw = dict(tau=0.06, sigma=0.04, rho=0.9, lam=0.05, nonneg=True, iso=iso)
    m = (rng.random((H, W)) < 0.4).astype(np.float32)
    atb = m * rng.standard_normal((H, W)).astype(np.float32)
    x = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    jx, jz0, jz1 = jnp.asarray(x), jnp.zeros((H, W)), jnp.zeros((H, W))
    tx, tz0, tz1 = _t(x), torch.zeros(H, W), torch.zeros(H, W)
    for _ in range(2):
        jx, jz0, jz1, jst = jax_sweepm2(jx, jz0, jz1, jnp.asarray(m), jnp.asarray(atb), interpret=True, **kw)
        tx, tz0, tz1, tst = tv_pds_sweepm2_step_plain(tx, tz0, tz1, _t(m), _t(atb), **kw)
        for a, b in ((tx, jx), (tz0, jz0), (tz1, jz1)):
            _close(a, b, 1e-4, 1e-5)
        _close(tst, np.asarray(jst)[0, :6], 1e-3, 1e-6)


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("nonneg", [True, False])
def test_megarm_plain_matches_pallas(rng, rank, iso, nonneg):
    """K7's plain version against ``tv_pds_megar_step(mask=)``, chained over
    three steps."""
    from pycsou_tpu.kernels.tvr import tv_pds_megar_step as jax_megar

    H, W = 96, 384
    u = rng.standard_normal((9, rank)) * 0.3
    v = rng.standard_normal((7, rank)) * 0.3
    filt = (u @ v.T).astype(np.float32)
    filt /= np.abs(filt).sum()
    us, vs = lowrank_factors(filt)
    Bf, Cf, Ba, Ca, R = make_megar_plan(us, vs, (H, W))
    fwd = SepFactors(us, vs, 4, 3, "cpu")
    adj2 = fwd.adjoint(2.0)
    m = (rng.random((H, W)) < 0.5).astype(np.float32)
    atb = rng.standard_normal((H, W)).astype(np.float32)
    kw = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.1, nonneg=nonneg, iso=iso)
    x = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    jx, jz0, jz1 = jnp.asarray(x), jnp.zeros((H, W)), jnp.zeros((H, W))
    tx, tz0, tz1 = _t(x), torch.zeros(H, W), torch.zeros(H, W)
    for _ in range(3):
        jx, jz0, jz1, jst = jax_megar(jx, jz0, jz1, jnp.asarray(atb), Bf, Cf, Ba, Ca, mega_r=R,
                                      interpret=True, mask=jnp.asarray(m), **kw)
        tx, tz0, tz1, tst = tv_pds_megarm_step_plain(tx, tz0, tz1, _t(m), _t(atb), fwd, adj2, **kw)
        for a, b in ((tx, jx), (tz0, jz0), (tz1, jz1)):
            _close(a, b, 3e-4, 3e-5)
        _close(tst, np.asarray(jst)[0, :6], 1e-3, 1e-7)


def test_masked_wrappers_run_the_plain_versions(rng):
    """On CPU tensors K5, K6 and K7's wrappers (K7 also through
    ``tv_pds_megar_step(mask=)``) return exactly their plain versions and
    launch nothing."""
    H, W = 20, 36
    x, m, atb, z0, z1 = (_t(rng.standard_normal((H, W))) for _ in range(5))
    us, vs = lowrank_factors(_gauss())
    fwd = SepFactors(us, vs, 2, 2, "cpu")
    adj2 = fwd.adjoint(2.0)
    kw = dict(tau=0.1, sigma=0.1, rho=0.9, lam=0.05)
    counters = (tv_pds_sweepm_step_stats, tv_pds_sweepm2_step, tv_pds_megarm_step, tv_pds_megar_step)
    before = [c.launches for c in counters]
    pairs = [
        (tv_pds_sweepm_step_stats(x, z0, z1, m, atb, **kw), tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw)),
        (tv_pds_sweepm2_step(x, z0, z1, m, atb, **kw), tv_pds_sweepm2_step_plain(x, z0, z1, m, atb, **kw)),
        (tv_pds_megar_step(x, z0, z1, atb, fwd, adj2, mask=m, **kw),
         tv_pds_megarm_step_plain(x, z0, z1, m, atb, fwd, adj2, **kw)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="m:"):
        tv_pds_sweepm_step_stats(x, z0, z1, m[:, :-1].contiguous(), atb, **kw)


# -- sampling operators ------------------------------------------------------


def _sampling_pair(kind, rng, shape):
    if kind == "masking":
        keep = rng.random(shape) < 0.5
        return jsamp.Masking(shape, keep), tops.Masking(shape, keep)
    if kind == "subsampling_dup":  # repeated indices: counts > 1
        idx = rng.integers(0, shape[0] * shape[1], shape[0] * shape[1])
        return jsamp.SubSampling(shape, idx), tops.SubSampling(shape, idx)
    if kind == "downsampling":
        return jsamp.DownSampling(shape, 2), tops.DownSampling(shape, 2)
    return jsamp.DownSampling(shape, (3, 1)), tops.DownSampling(shape, (3, 1))


@pytest.mark.parametrize("kind", ["masking", "subsampling_dup", "downsampling", "downsampling_31"])
def test_sampling_ops_match_jax(rng, kind):
    shape = (13, 10)  # odd: DownSampling's codomain is ceil(n / f)
    jop, top = _sampling_pair(kind, rng, shape)
    assert top.dim_shape == tuple(jop.dim_shape) and top.codim_shape == tuple(jop.codim_shape)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(top.codim_shape).astype(np.float32)
    np.testing.assert_array_equal(top(_t(x)).numpy(), np.asarray(jop(jnp.asarray(x))))
    _close(top.adjoint(_t(y)), jop.adjoint(jnp.asarray(y)), 1e-6, 1e-6)
    counts = top.adjoint(torch.ones(top.codim_shape))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jop.adjoint(jnp.ones(jop.codim_shape))))
    if kind == "subsampling_dup":
        assert float(counts.max()) > 1.0  # the adjoint adds
    else:
        assert set(np.unique(counts.numpy())) <= {0.0, 1.0}  # the adjoint sets


# -- the slice through the user's entry points -------------------------------


def _ops(kind, rng):
    """(jax op, torch op) pairs of the four masked F flavours."""
    keep = rng.random(S) < 0.6
    if kind == "masking":
        return jsamp.Masking(S, keep), tops.Masking(S, keep)
    if kind == "downsampling":
        return jsamp.DownSampling(S, 2), tops.DownSampling(S, 2)
    if kind == "subsampling":
        idx = rng.integers(0, S[0] * S[1], S[0] * S[1] // 2)
        return jsamp.SubSampling(S, idx), tops.SubSampling(S, idx)
    h = _gauss() if kind == "blur_gauss" else _rank2()
    return (jsamp.Masking(S, keep) * jconv.Convolve2D(S, jnp.asarray(h)),
            tops.Masking(S, keep) * tops.Convolve2D(S, h))


def _pdss(kind, rng, iso=True, **kw):
    jop, top = _ops(kind, rng)
    x_true = np.abs(rng.standard_normal(S)).astype(np.float32)
    y = np.asarray(jop(jnp.asarray(x_true)))
    y = (y + 0.01 * rng.standard_normal(y.shape)).astype(np.float32)
    jH = LAM * (jpen.L21Norm((2,) + S, axis=0) if iso else jpen.L1Norm((2,) + S))
    tH = LAM * (tfunc.L21Norm((2,) + S, axis=0) if iso else tfunc.L1Norm((2,) + S))
    jp = jopt.PDS(S, F=jfunc.SquaredL2Loss(jop.codim_shape, data=jnp.asarray(y)) * jop,
                  G=jfunc.NonNegativeOrthant(S), H=jH, K=jdiff.Gradient(S), **kw)
    tp = topt.PDS(S, F=tfunc.SquaredL2Loss(top.codim_shape, data=y) * top,
                  G=tfunc.NonNegativeOrthant(S), H=tH, K=tops.Gradient(S), **kw)
    return jp, tp


def _assert_iterates_close(tstate, jstate):
    scale = float(np.abs(np.asarray(jstate["x"])).max())
    for k in ("x", "z0", "z1"):
        np.testing.assert_allclose(
            tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-4, atol=1e-5 * scale, err_msg=k
        )


@pytest.mark.parametrize("kind,mode", [
    ("masking", "mask"), ("downsampling", "mask"), ("subsampling", "mask"),
    ("blur_gauss", "combined"), ("blur_rank2", "combined"),
])
def test_masked_pds_matches_jax(rng, kind, mode):
    jp, tp = _pdss(kind, rng, max_iter=100)
    assert type(tp._fused).__name__ == type(jp._fused).__name__ == "TVDeconvolution"
    assert tp._fused.mode == mode and tp._fused.stencil_mode == "plain"  # auto on the CPU
    assert (jp._fused.conv is not None) == (mode == "combined")
    assert (tp.tau, tp.sigma, tp.rho) == (jp.tau, jp.sigma, jp.rho)
    assert tp._fused.beta == pytest.approx(jp._fused.beta, rel=1e-6)
    np.testing.assert_array_equal(tp._fused.mask.numpy(), np.asarray(jp._fused.mask))
    js, ts = jp.run_fixed(20), tp.run_fixed(20)
    assert ts["it"] == int(js["it"]) == 20
    _assert_iterates_close(ts, js)
    np.testing.assert_allclose(ts["history"][:20].numpy(), np.asarray(js["history"])[:20], rtol=1e-4)


def test_masked_fused_matches_generic_chain(rng):
    """Blurred super-resolution fused (TVDeconvolution, combined mode)
    against the same expression stepped generically."""
    _, fused = _pdss("blur_rank2", rng, max_iter=100)
    _, generic = _pdss("blur_rank2", np.random.default_rng(17), max_iter=100, fuse=False)
    assert generic._fused is None
    fs, gs = fused.run_fixed(20), generic.run_fixed(20)
    scale = float(fs["x"].abs().max())
    np.testing.assert_allclose(gs["x"].numpy(), fs["x"].numpy(), rtol=1e-4, atol=1e-5 * scale)
    z = torch.stack([fs["z0"], fs["z1"]]).numpy()
    np.testing.assert_allclose(gs["z"].numpy(), z, rtol=1e-4, atol=1e-5 * scale)


def test_masked_warm_state_through_convert(rng):
    """A warm JAX mask-mode state (x, z0, z1, it, histories) carries across
    through state_from_numpy unchanged, and both packages go on together."""
    jp, tp = _pdss("masking", rng, max_iter=100)
    warm = jp.run_fixed(8)
    tstate = state_from_numpy({k: np.asarray(v) for k, v in warm.items()}, "cpu")
    assert {"x", "z0", "z1", "it", "history"} <= set(tstate) and tstate["it"] == 8
    js, ts = jp.run_fixed(12, state=warm), tp.run_fixed(12, state=tstate)
    assert ts["it"] == int(js["it"]) == 20
    _assert_iterates_close(ts, js)
    np.testing.assert_allclose(ts["history"][8:20].numpy(), np.asarray(js["history"])[8:20], rtol=1e-4)


@pytest.mark.parametrize("mode,iso", [("mask", True), ("mask", False), ("combined", True), ("combined", False)])
def test_masked_objective_matches_jax(rng, mode, iso):
    """Observed pixels only, ``yc = y / max(m, 1)``; with SubSampling counts
    in mask mode."""
    m = rng.integers(0, 3, S).astype(np.float32)  # counts 0, 1, 2
    y = (m * rng.standard_normal(S)).astype(np.float32)
    filt = _gauss() if mode == "combined" else None
    j = jopt.TVDeconvolution(S, jnp.asarray(y), LAM, filt=filt, mask=jnp.asarray(m), isotropic=iso)
    t = topt.TVDeconvolution(S, y, LAM, filt=filt, mask=m, isotropic=iso)
    assert t.mode == mode
    x = np.abs(rng.standard_normal(S)).astype(np.float32)
    np.testing.assert_allclose(float(t.objective(_t(x))), float(j.objective(jnp.asarray(x))), rtol=1e-5)


@pytest.mark.parametrize("iso", [True, False])
def test_cps_denoise_matches_jax(rng, iso):
    """CPS TV denoising fuses onto a denoising TVDeconvolution with tau' =
    tau / (1 + 2 tau), in both packages, and agrees with the JAX package
    and with its own generic chain."""
    y = np.abs(rng.standard_normal(S)).astype(np.float32)
    jH = LAM * (jpen.L21Norm((2,) + S, axis=0) if iso else jpen.L1Norm((2,) + S))
    tH = LAM * (tfunc.L21Norm((2,) + S, axis=0) if iso else tfunc.L1Norm((2,) + S))
    jc = jopt.CPS(S, G=jfunc.SquaredL2Loss(S, data=jnp.asarray(y)), H=jH, K=jdiff.Gradient(S), max_iter=100)
    tc = topt.CPS(S, G=tfunc.SquaredL2Loss(S, data=y), H=tH, K=tops.Gradient(S), max_iter=100)
    assert type(tc._fused).__name__ == type(jc._fused).__name__ == "TVDeconvolution"
    assert tc._fused.tau == jc._fused.tau == pytest.approx(tc.tau / (1 + 2 * tc.tau))
    assert tc._fused.nonneg is False and tc.rho == 1.0
    js, ts = jc.run_fixed(20), tc.run_fixed(20)
    _assert_iterates_close(ts, js)
    gs = topt.CPS(S, G=tfunc.SquaredL2Loss(S, data=y), H=tH, K=tops.Gradient(S), max_iter=100,
                  fuse=False).run_fixed(20)
    scale = float(ts["x"].abs().max())
    np.testing.assert_allclose(gs["x"].numpy(), ts["x"].numpy(), rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("entry", ["tvdeconvolution", "pds"])
def test_large_denoise_reroute_matches_jax(entry):
    """Denoising at 2**21 pixels runs in mask mode with an all-ones mask
    and a 1x1 marker PSF, as in the reference; 6 iterations agree."""
    big = (2048, 1024)
    y = np.random.default_rng(3).standard_normal(big).astype(np.float32)
    if entry == "tvdeconvolution":
        j = jopt.TVDeconvolution(big, jnp.asarray(y), LAM)
        t = topt.TVDeconvolution(big, y, LAM)
        jt, tt = j, t
    else:
        H = lambda pkg: LAM * pkg.L21Norm((2,) + big, axis=0)  # noqa: E731
        j = jopt.PDS(big, F=jfunc.SquaredL2Loss(big, data=jnp.asarray(y)), H=H(jpen),
                     K=jdiff.Gradient(big), max_iter=50)
        t = topt.PDS(big, F=tfunc.SquaredL2Loss(big, data=y), H=H(tfunc), K=tops.Gradient(big), max_iter=50)
        jt, tt = j._fused, t._fused
    assert jt.mask is not None and tt.mode == "mask" and tt.stencil_mode == "plain"
    assert tuple(tt.filt.shape) == (1, 1) and bool((tt.mask == 1).all())
    assert (tt.tau, tt.beta) == (jt.tau, jt.beta)
    js, ts = j.run_fixed(6), t.run_fixed(6)
    _assert_iterates_close(ts, js)


def _sweepm2_pair(monkeypatch, rng, **kw):
    """The sweepm2 engine in both packages on the CPU: the JAX kernel in
    interpret mode, the port's K6 wrapper on CPU tensors (its plain
    version).  The port refuses a CUDA engine on a CPU device, so its
    solver is switched over with ``replace``."""
    import pycsou_tpu.kernels.tv as jtv

    real = jtv.tv_pds_sweepm2_step
    monkeypatch.setattr(jtv, "tv_pds_sweepm2_step", lambda *a, **k: real(*a, interpret=True, **k))
    H, W = 64, 256
    keep = rng.random((H, W)) < 0.6
    y = (keep * np.abs(rng.standard_normal((H, W)))).astype(np.float32)
    m = keep.astype(np.float32)
    j = jopt.TVDeconvolution((H, W), jnp.asarray(y), 0.05, mask=jnp.asarray(m), stencil="sweepm2",
                             use_pallas=True, **kw)
    t = topt.TVDeconvolution((H, W), y, 0.05, mask=m, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        topt.TVDeconvolution((H, W), y, 0.05, mask=m, stencil="sweepm2")
    t = t.replace(stencil_mode="sweepm2", iters_per_step=2)
    assert j.iters_per_step == t.iters_per_step == 2
    return j, t


def test_double_step_bookkeeping_matches_reference(rng, monkeypatch):
    """iters_per_step = 2 against the reference's IterativeSolver:
    run_fixed(odd n) rounds up to whole steps, ``it`` and the history rows
    are in iteration units (the odd rows stay unmeasured), and the iterates
    agree."""
    j, t = _sweepm2_pair(monkeypatch, rng, max_iter=60)
    n0 = tv_pds_sweepm2_step.launches
    js, ts = j.run_fixed(7), t.run_fixed(7)
    assert ts["it"] == int(js["it"]) == 8
    assert tv_pds_sweepm2_step.launches == n0  # CPU tensors: no launch
    _assert_iterates_close(ts, js)
    th, jh = ts["history"][:8].numpy(), np.asarray(js["history"])[:8]
    assert np.isnan(th[0::2]).all() and np.isnan(jh[0::2]).all()
    np.testing.assert_allclose(th[1::2], jh[1::2], rtol=1e-4)
    js, ts = j.run_fixed(5, state=js), t.run_fixed(5, state=ts)
    assert ts["it"] == int(js["it"]) == 14


def test_double_step_solve_matches_reference(rng, monkeypatch):
    """solve() on the double-step engine stops at the iteration the
    reference stops at: ``converged_at`` (iteration units, even) equals
    the reference's ``n_iter``; the port's 16-iteration chunk is 8 steps."""
    j, t = _sweepm2_pair(monkeypatch, rng, max_iter=400, min_iter=10, accuracy_threshold=2e-3)
    ji, ti = j.solve(), t.solve()
    assert ji.converged and ti.converged
    assert ti.converged_at == ji.n_iter and ti.converged_at % 2 == 0
    assert ti.n_iter % 16 == 0 and ti.converged_at <= ti.n_iter < ti.converged_at + 16
    np.testing.assert_allclose(ti.history[: ji.n_iter], np.asarray(ji.history), rtol=1e-3)
