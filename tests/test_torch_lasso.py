"""The LASSO slice of the port on the CPU against the JAX package: K8's plain
version against the Pallas FISTA kernel in interpret mode, the
LassoDeconvolution engines, APGD (fused and generic), FBS and DRS, the
LASSO matcher and the state conversion.  The same numpy inputs go to both
packages.

Tolerances: rtol 3e-4 / atol 3e-5 for one kernel step (the TPU kernel's
bf16x3 dots against f32 convolutions, as for K1-K4); rtol 1e-4 / atol 1e-5
times max |x| for 40 iterations of two solvers, 1e-3 for their metric
histories (partial sums in another order); the port's own engines agree
bit for bit on the CPU (the same plain operations).
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.opt as jopt
import pycsou_tpu.opt.fuse as jfuse
from pycsou_tpu.kernels.fista import lasso_fista_step as jax_fista, make_fista_plan
from pycsou_tpu.ops.conv import Convolve2D as JConv, lowrank_factors
from pycsou_tpu.ops.sampling import Masking as JMasking
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.kernels.conv2d import SepFactors
from pycsou_tpu_torch.kernels.fista import lasso_fista_step
from pycsou_tpu_torch.ops import Convolve2D, ConvGram2D, Masking
from pycsou_tpu_torch.opt import fuse as tfuse
from pycsou_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


S = (64, 384)  # the Pallas kernel's smallest shape (32-row tiles, W % 128, W >= 384)
LAM = 0.02


def _gauss(k=7, s=1.4):
    g = np.exp(-((np.arange(k) - k // 2) ** 2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _rank2(k=7):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h = np.outer(g(1.5), g(1.5)) + 0.35 * np.outer(g(0.8), g(2.5))
    return (h / h.sum()).astype(np.float32)


def _problem(rng, h, shape=S):
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y = np.asarray(JConv(shape, jnp.asarray(h)).apply(jnp.asarray(x_true)))
    return x_true, (y + 0.01 * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close_state(ts, js, keys=("x", "x_temp"), rtol=1e-4, atol=1e-5):
    scale = max(1.0, float(np.abs(np.asarray(js["x"])).max()))
    for k in keys:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=rtol, atol=atol * scale, err_msg=k)


@pytest.mark.parametrize("psf", ["gauss", "rank2"])
@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("mom", [0.0, 0.4])
def test_fista_plain_matches_pallas(rng, psf, nonneg, mom):
    """K8's plain version against the Pallas kernel in interpret mode: x+,
    v+ and the stats lanes 0-5 (rtol 3e-4 / atol 3e-5; stats rtol 1e-3)."""
    h = _gauss() if psf == "gauss" else _rank2()
    us, vs = lowrank_factors(h)
    fwd = SepFactors(us, vs, h.shape[0] // 2, h.shape[1] // 2, "cpu")
    Bf, Cf, Ba, Ca, r = make_fista_plan(us, vs, S)
    v = rng.standard_normal(S).astype(np.float32)
    xp = rng.standard_normal(S).astype(np.float32)
    atb = rng.standard_normal(S).astype(np.float32)
    kw = dict(tau=0.3, lam=0.1, nonneg=nonneg)
    jx, jv, jst = jax_fista(jnp.asarray(v), jnp.asarray(xp), jnp.asarray(atb), Bf, Cf, Ba, Ca,
                            jnp.asarray([mom], jnp.float32), interpret=True, mega_r=r, **kw)
    before = lasso_fista_step.launches
    tx, tv, tst = lasso_fista_step(_t(v), _t(xp), _t(atb), torch.tensor([mom]), fwd, fwd.adjoint(2.0), **kw)
    assert lasso_fista_step.launches == before  # the CPU runs the plain version, no kernel
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst)[0, :6], rtol=1e-3, atol=1e-7)
    if nonneg:
        assert float(tx.min()) >= 0.0


@pytest.mark.parametrize("acc", ["BT", "CD", None])
def test_lasso_matches_jax(rng, acc):
    """LassoDeconvolution over 40 iterations: the port's K8 engine (plain
    version, use_pallas='interpret') and its gram engine against the JAX
    gram engine (iterates, t, n and the metric history), and against the
    JAX K8 engine in interpret mode within 1e-3 x max |x|: the TPU
    kernel's bf16x3 dots compound over the iterations, and the JAX
    package's own two engines differ by up to 7.4e-4 on this problem."""
    h = _gauss()
    _, y = _problem(rng, h)
    mk = lambda pkg, up: pkg.LassoDeconvolution(S, y, LAM, filt=h, acceleration=acc, use_pallas=up,  # noqa: E731
                                                max_iter=100)
    jl, jm = mk(jopt, False), mk(jopt, "interpret")
    tl, tg = mk(topt, "interpret"), mk(topt, False)
    assert jm.engine == tl.engine == "megaf" and jl.engine == tg.engine == "gram"
    assert (tl.tau, tl.beta) == (jl.tau, jl.beta)
    js, ts, gs = jl.run_fixed(40), tl.run_fixed(40), tg.run_fixed(40)
    _close_state(ts, js)
    _close_state(ts, jm.run_fixed(40), atol=1e-3)
    assert int(ts["n"]) == int(js["n"]) == 40 and ts["n"].dtype == torch.int32
    np.testing.assert_allclose(float(ts["t"]), float(js["t"]), rtol=1e-6)
    np.testing.assert_allclose(ts["history"][:40].numpy(), np.asarray(js["history"])[:40], rtol=1e-3, atol=1e-6)
    # the two engines of the port: the same plain operations
    for k in ("x", "x_temp"):
        assert torch.equal(ts[k], gs[k]), k
    np.testing.assert_allclose(gs["history"][:40].numpy(), ts["history"][:40].numpy(), rtol=1e-5)


def _apgd(pkg, fpkg, ppkg, h, y, conv, **kw):
    F = fpkg.SquaredL2Loss(S, data=y) * conv(S, h)
    return pkg.APGD(S, F=F, G=LAM * ppkg.L1Norm(S), **kw)


def test_apgd_fused_generic_and_jax(rng):
    """APGD on the LASSO: fused (LassoDeconvolution) == fuse=False on the
    port (bit for bit on the CPU), and both within tolerance of the JAX
    APGD's generic chain after 40 iterations."""
    h = _rank2()
    _, y = _problem(rng, h)
    tf = _apgd(topt, tfunc, tfunc, h, y, Convolve2D, max_iter=100)
    tg = _apgd(topt, tfunc, tfunc, h, y, Convolve2D, max_iter=100, fuse=False)
    jg = _apgd(jopt, jfunc, jpen, h, jnp.asarray(y), JConv, max_iter=100, fuse=False)
    assert type(tf._fused).__name__ == "LassoDeconvolution" and tf._fused.engine == "gram"
    assert tg._fused is None and tf._fused.lam == LAM and tf._fused.tau == tf.tau == jg.tau
    fs, gs, js = tf.run_fixed(40), tg.run_fixed(40), jg.run_fixed(40)
    for k in ("x", "x_temp"):
        assert torch.equal(fs[k], gs[k]), k
    _close_state(gs, js)
    np.testing.assert_allclose(gs["history"][:40].numpy(), np.asarray(js["history"])[:40], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(fs["history"][:40].numpy(), gs["history"][:40].numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        float(tg.objective(gs["x_temp"])), float(jg.objective(jnp.asarray(gs["x_temp"].numpy()))), rtol=1e-4
    )
    # solve() on the fused delegate: converges and reports both variables
    info = _apgd(topt, tfunc, tfunc, h, y, Convolve2D, max_iter=1000, accuracy_threshold=1e-3).solve()
    assert info.converged and set(info.diagnostics) == {"x", "x_temp"}


def _small(rng, shape=(24, 32)):
    h = _gauss(5, 1.0)
    x_true = np.zeros(shape, np.float32)
    x_true[rng.integers(0, shape[0], 8), rng.integers(0, shape[1], 8)] = 1.0 + rng.random(8)
    y = np.asarray(JConv(shape, jnp.asarray(h)).apply(jnp.asarray(x_true)))
    return h, x_true, (y + 0.01 * rng.standard_normal(shape)).astype(np.float32)


def test_fbs_matches_apgd(rng):
    """The reference's FBS-against-APGD check on a small sparse
    deconvolution: FBS (rho = 0.9, generic chain) converges to APGD's
    solution; at rho = 1 it fuses onto the LASSO engine with no momentum and
    gives the generic chain's iterates."""
    shape = (24, 32)
    h, _, y = _small(rng, shape)
    F = tfunc.SquaredL2Loss(shape, data=y) * Convolve2D(shape, h)
    G = LAM * tfunc.L1Norm(shape)
    apgd = topt.APGD(shape, F=F, G=G, max_iter=4000, accuracy_threshold=1e-8, min_iter=50).solve()
    fbs = topt.FBS(shape, F=F, G=G, max_iter=8000, accuracy_threshold=1e-8, min_iter=50)
    assert fbs._fused is None
    np.testing.assert_allclose(fbs.solve()["x"].numpy(), apgd["x_temp"].numpy(), atol=5e-3)
    mk = lambda fuse: topt.FBS(shape, F=F, G=G, rho=1.0, max_iter=200, fuse=fuse)  # noqa: E731
    fused, generic = mk(True), mk(False)
    assert type(fused._fused).__name__ == "LassoDeconvolution" and fused._fused.acceleration is None
    fs, gs = fused.run_fixed(40), generic.run_fixed(40)
    np.testing.assert_allclose(fs["x"].numpy(), gs["x"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fs["history"][:40].numpy(), gs["history"][:40].numpy(), rtol=1e-4)
    assert mk(True).solve().n_iter > 0


def test_fbs_rho_relaxation_stays_generic(rng, caplog):
    shape = (24, 32)
    h, _, y = _small(rng, shape)
    F = tfunc.SquaredL2Loss(shape, data=y) * Convolve2D(shape, h)
    with caplog.at_level(logging.WARNING, logger="pycsou_tpu_torch.fuse"):
        s = topt.FBS(shape, F=F, G=LAM * tfunc.L1Norm(shape), max_iter=50)
    assert s._fused is None and any("rho" in r.message for r in caplog.records)


def test_drs_lasso_closed_form(rng):
    """DRS on min ||x - y||^2 + lam |x|_1 reaches soft(y, lam / 2) (the
    reference's check), and matches the JAX DRS iterates."""
    n = 10
    y = rng.standard_normal(n).astype(np.float32)
    lam = 0.6
    drs = topt.DRS((n,), G=tfunc.SquaredL2Norm((n,)).shifter(-_t(y)), H=lam * tfunc.L1Norm((n,)), tau=0.5,
                   max_iter=4000, accuracy_threshold=1e-9, min_iter=100)
    x = drs.solve()["x"].numpy()
    np.testing.assert_allclose(x, np.sign(y) * np.maximum(np.abs(y) - lam / 2, 0.0), atol=2e-3)
    jdrs = jopt.DRS((n,), G=jpen.SquaredL2Norm((n,)).shifter(-jnp.asarray(y)), H=lam * jpen.L1Norm((n,)),
                    tau=0.5, max_iter=100)
    np.testing.assert_allclose(drs.run_fixed(30)["x"].numpy(), np.asarray(jdrs.run_fixed(30)["x"]),
                               rtol=1e-5, atol=1e-6)


def _cases(rng):
    """(label, builder(pkg namespace) -> (F, G)) for a handful of LASSO
    expressions and near misses."""
    h = _gauss()
    y = rng.standard_normal(S).astype(np.float32)
    keep = rng.random(S) < 0.6

    def build(p, kind):
        data = p["arr"](y)
        conv = p["Conv"](S, h)
        lsq = p["func"].SquaredL2Loss(S, data=data)
        l1 = p["pen"].L1Norm(S)
        F, G = lsq * conv, LAM * l1
        if kind == "plain L1":
            G = l1
        elif kind == "denoise":
            F = lsq
        elif kind == "G squared l2":
            G = p["pen"].SquaredL2Norm(S)
        elif kind == "G nonneg":
            G = p["func"].NonNegativeOrthant(S)
        elif kind == "G shifted":
            G = l1.shifter(p["arr"](np.ones(S, np.float32)))
        elif kind == "F masked":
            M = p["Mask"](S, keep)
            F = p["func"].SquaredL2Loss(M.codim_shape, data=M(data)) * M
        elif kind == "F masked, G squared l2":
            M = p["Mask"](S, keep)
            F = p["func"].SquaredL2Loss(M.codim_shape, data=M(data)) * M
            G = p["pen"].SquaredL2Norm(S)
        elif kind == "F scaled":
            F = 0.5 * F
        elif kind == "G on another domain":
            G = LAM * p["pen"].L1Norm((S[0], S[1] // 2))
        return F, G

    return build


KINDS = ["lasso", "plain L1", "denoise", "G squared l2", "G nonneg", "G shifted", "F masked",
         "F masked, G squared l2", "F scaled", "G on another domain"]


@pytest.mark.parametrize("kind", KINDS)
def test_match_lasso_as_the_reference(rng, kind):
    """match_lasso fuses exactly where the reference's does, and
    explain_lasso_mismatch gives a note exactly where the reference's does."""
    build = _cases(rng)
    jp = {"arr": jnp.asarray, "Conv": lambda s, h: JConv(s, jnp.asarray(h)), "func": jfunc, "pen": jpen,
          "Mask": lambda s, k: JMasking(s, jnp.asarray(k))}
    tp = {"arr": _t, "Conv": Convolve2D, "func": tfunc, "pen": tfunc,
          "Mask": lambda s, k: Masking(s, k)}
    jF, jG = build(jp, kind)
    tF, tG = build(tp, kind)
    jm = jfuse.match_lasso(S, jF, jG, 0.3, "CD", 75.0)
    tm = tfuse.match_lasso(S, tF, tG, 0.3, "CD", 75.0)
    assert (jm is None) == (tm is None)
    if tm is not None:
        assert (tm.lam, tm.tau, tm.acceleration) == (jm.lam, jm.tau, jm.acceleration)
    jn = jfuse.explain_lasso_mismatch(S, jF, jG)
    tn = tfuse.explain_lasso_mismatch(S, tF, tG)
    assert (jn is None) == (tn is None), (jn, tn)
    if tn is not None:
        assert tn.startswith("APGD expression NOT fused")


def test_full_rank_psf_runs_generic_and_says_why(rng, caplog):
    """A full-rank PSF: APGD fuses it onto LassoDeconvolution's "gram"
    engine, whose Gram is the FFT Gram ConvGram2D, as the reference fuses
    it; no note is logged, and after 20 iterations the iterates are the
    reference's (rtol 1e-4 / atol 1e-5 x max |x|)."""
    shape = (24, 32)
    hf = np.random.default_rng(0).random((5, 5)).astype(np.float32)
    hf /= hf.sum()
    y = rng.standard_normal(shape).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger="pycsou_tpu_torch.fuse"):
        t = topt.APGD(shape, F=tfunc.SquaredL2Loss(shape, data=y) * Convolve2D(shape, hf),
                      G=LAM * tfunc.L1Norm(shape), max_iter=50)
    assert not any("NOT fused" in r.message for r in caplog.records)
    assert type(t._fused) is topt.LassoDeconvolution and t._fused.engine == "gram"
    assert type(t._fused.gram) is ConvGram2D
    j = jopt.APGD(shape, F=jfunc.SquaredL2Loss(shape, data=jnp.asarray(y)) * JConv(shape, jnp.asarray(hf)),
                  G=LAM * jpen.L1Norm(shape), max_iter=50)
    assert j._fused is not None and j._fused.engine == "gram"
    _close_state(t.run_fixed(20), j.run_fixed(20))


def test_lasso_engine_requests(rng):
    """use_pallas: True needs CUDA (raises here), 'interpret' runs K8's
    plain version on the CPU, False the gram chain; a full-rank PSF runs
    the gram chain through the FFT convolution."""
    y = rng.standard_normal(S).astype(np.float32)
    h = _gauss()
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            topt.LassoDeconvolution(S, y, LAM, filt=h, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas"):
        topt.LassoDeconvolution(S, y, LAM, filt=h, use_pallas="xla")
    with pytest.raises(ValueError, match="acceleration"):
        topt.LassoDeconvolution(S, y, LAM, filt=h, acceleration="nesterov")
    assert topt.LassoDeconvolution(S, y, LAM, filt=h).engine == "gram"  # auto on the CPU
    hf = np.random.default_rng(0).random((5, 5)).astype(np.float32)
    full = topt.LassoDeconvolution((24, 32), y[:24, :32], LAM, filt=hf / hf.sum(), max_iter=20)
    assert full.engine == "gram" and full.run_fixed(5)["x"].shape == (24, 32)


def test_lasso_nonneg_and_recovery(rng):
    """nonneg keeps the iterates >= 0; the sparse spikes come back better
    than the blurred observation; the objective matches the JAX one."""
    shape = (24, 32)
    h, x_true, y = _small(rng, shape)
    s = topt.LassoDeconvolution(shape, y, 0.01, filt=h, nonneg=True, max_iter=400)
    st = s.run_fixed(300)
    assert float(st["x_temp"].min()) >= 0.0
    assert np.linalg.norm(st["x_temp"].numpy() - x_true) < np.linalg.norm(y - x_true)
    j = jopt.LassoDeconvolution(shape, jnp.asarray(y), 0.01, filt=h, nonneg=True)
    np.testing.assert_allclose(float(s.objective(_t(x_true))), float(j.objective(jnp.asarray(x_true))), rtol=1e-4)


def test_lasso_state_round_trip(rng):
    """A warm JAX LASSO state (x, x_temp, t, n, _stats) through
    state_from_numpy: the port continues with the same iterates; integer
    counters stay int32 both ways."""
    h = _gauss()
    _, y = _problem(rng, h)
    jl = jopt.LassoDeconvolution(S, y, LAM, filt=h, use_pallas="interpret", max_iter=100)
    tl = topt.LassoDeconvolution(S, y, LAM, filt=h, use_pallas="interpret", max_iter=100)
    warm = jl.run_fixed(8)
    tstate = state_from_numpy({k: np.asarray(v) for k, v in warm.items()}, "cpu")
    assert tstate["n"].dtype == torch.int32 and tstate["t"].dtype == torch.float32 and tstate["it"] == 8
    ts, js = tl.run_fixed(12, state=tstate), jl.run_fixed(12, state=warm)
    assert ts["it"] == 20 and int(ts["n"]) == 20
    _close_state(ts, js)
    back = state_to_numpy(ts)
    assert back["n"].dtype == np.int32 and back["it"].dtype == np.int32
    np.testing.assert_array_equal(back["x_temp"], ts["x_temp"].numpy())
