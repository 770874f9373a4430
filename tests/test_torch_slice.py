"""The TV-deconvolution slice of the port end to end on the CPU: the
README's PDS expression in pycsou_tpu_torch against the same expression in
pycsou_tpu, both fused.

After 20 iterations x, z0 and z1 agree within rtol 1e-4 and atol
1e-5 * max|x| (the two packages sum convolutions in different orders);
tau and sigma are equal bit for bit (same numpy Lipschitz code); the
stopping-metric history agrees to 1e-4.
"""
import logging

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
from pycsou_tpu_torch.opt.fuse import explain_tv_mismatch
from pycsou_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


S = (48, 64)
LAM = 0.05


def _gauss(k=9, s=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _rank2(k=9):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h = np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))
    return (h / h.sum()).astype(np.float32)


def _problem(rng, h):
    x_true = np.abs(rng.standard_normal(S)).astype(np.float32)
    y = jconv.Convolve2D(S, jnp.asarray(h)).apply(jnp.asarray(x_true))
    y = np.asarray(y) + 0.01 * rng.standard_normal(S).astype(np.float32)
    return x_true, y.astype(np.float32)


def _jax_pds(h, y, iso=True, **kw):
    H = LAM * (jpen.L21Norm((2,) + S, axis=0) if iso else jpen.L1Norm((2,) + S))
    return jopt.PDS(
        S, F=jfunc.SquaredL2Loss(S, data=jnp.asarray(y)) * jconv.Convolve2D(S, jnp.asarray(h)),
        G=jfunc.NonNegativeOrthant(S), H=H, K=jdiff.Gradient(S), **kw,
    )


def _torch_pds(h, y, iso=True, **kw):
    H = LAM * (tfunc.L21Norm((2,) + S, axis=0) if iso else tfunc.L1Norm((2,) + S))
    return topt.PDS(
        S, F=tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, h),
        G=tfunc.NonNegativeOrthant(S), H=H, K=tops.Gradient(S), **kw,
    )


def _assert_iterates_close(tstate, jstate):
    scale = float(np.abs(np.asarray(jstate["x"])).max())
    for k in ("x", "z0", "z1"):
        np.testing.assert_allclose(
            tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-4, atol=1e-5 * scale, err_msg=k
        )


@pytest.mark.parametrize("psf,iso", [("gauss", True), ("rank2", True), ("gauss", False)])
def test_pds_slice_matches_jax(rng, psf, iso):
    h = _gauss() if psf == "gauss" else _rank2()
    _, y = _problem(rng, h)
    jp = _jax_pds(h, y, iso=iso, max_iter=100)
    tp = _torch_pds(h, y, iso=iso, max_iter=100)
    assert type(jp._fused).__name__ == type(tp._fused).__name__ == "TVDeconvolution"
    assert tp._fused.stencil_mode == "plain"  # auto on a CPU device
    assert (tp.tau, tp.sigma, tp.rho) == (jp.tau, jp.sigma, jp.rho)
    assert tp._fused.iso is iso
    js = jp.run_fixed(20)
    ts = tp.run_fixed(20)
    assert ts["it"] == int(js["it"]) == 20
    _assert_iterates_close(ts, js)
    np.testing.assert_allclose(ts["history"][:20].numpy(), np.asarray(js["history"])[:20], rtol=1e-4)
    np.testing.assert_allclose(
        ts["var_history"][:20].numpy(), np.asarray(js["var_history"])[:20], rtol=1e-4
    )


def test_fused_matches_generic_chain(rng):
    """fuse=True (TVDeconvolution, plain engine) against fuse=False (the
    expression stepped generically: K2 gradient, Gradient, L21 prox)."""
    h = _rank2()
    _, y = _problem(rng, h)
    fused = _torch_pds(h, y, max_iter=100)
    generic = _torch_pds(h, y, max_iter=100, fuse=False)
    assert generic._fused is None
    fs, gs = fused.run_fixed(20), generic.run_fixed(20)
    scale = float(fs["x"].abs().max())
    np.testing.assert_allclose(gs["x"].numpy(), fs["x"].numpy(), rtol=1e-4, atol=1e-5 * scale)
    z = torch.stack([fs["z0"], fs["z1"]]).numpy()
    np.testing.assert_allclose(gs["z"].numpy(), z, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(gs["history"][:20].numpy(), fs["history"][:20].numpy(), rtol=1e-4)


def test_generic_chain_matches_jax_generic(rng):
    h = _gauss()
    _, y = _problem(rng, h)
    js = _jax_pds(h, y, max_iter=50, fuse=False).run_fixed(10)
    ts = _torch_pds(h, y, max_iter=50, fuse=False).run_fixed(10)
    scale = float(np.abs(np.asarray(js["x"])).max())
    for k in ("x", "z"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(ts["history"][:10].numpy(), np.asarray(js["history"])[:10], rtol=1e-4)


def test_warm_state_through_convert(rng):
    """Both packages continue from the same warm JAX state (moved through
    state_to_numpy/state_from_numpy) and stay together."""
    h = _gauss()
    _, y = _problem(rng, h)
    jp, tp = _jax_pds(h, y, max_iter=100), _torch_pds(h, y, max_iter=100)
    warm = jp.run_fixed(8)
    arrays = {k: np.asarray(v) for k, v in warm.items()}
    tstate = state_from_numpy(arrays, "cpu")
    assert tstate["it"] == 8 and "_stats" not in tstate  # the JAX CPU engine emits none
    js = jp.run_fixed(12, state=warm)
    ts = tp.run_fixed(12, state=tstate)
    assert ts["it"] == int(js["it"]) == 20
    _assert_iterates_close(ts, js)
    np.testing.assert_allclose(ts["history"][8:20].numpy(), np.asarray(js["history"])[8:20], rtol=1e-4)


def test_convert_round_trip(rng):
    state = {
        "x": rng.standard_normal(S).astype(np.float32),
        "z0": rng.standard_normal(S).astype(np.float32),
        "z1": rng.standard_normal(S).astype(np.float32),
        "_stats": rng.random(6).astype(np.float32),
        "it": np.int32(7),
        "history": np.full(12, np.nan, np.float32),
    }
    back = state_to_numpy(state_from_numpy(state, "cpu"))
    assert back.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    generic = {"x": state["x"], "z": np.stack([state["z0"], state["z1"]]), "it": 3}
    back = state_to_numpy(state_from_numpy(generic, "cpu"))
    np.testing.assert_array_equal(back["z"], generic["z"])
    assert back["it"].dtype == np.int32


def test_tv_solve_recovers_and_stops(rng):
    """solve() on the plain engine: converges, the recovery beats the blurred
    observation, and the metric history is the one the run measured."""
    h = _gauss()
    x_true, y = _problem(rng, h)
    s = topt.TVDeconvolution(S, y, LAM, filt=h, max_iter=400, min_iter=10, accuracy_threshold=1e-4)
    info = s.solve()
    assert info.converged and info.converged_at <= info.n_iter < info.converged_at + 16
    assert info.history[info.converged_at - 1] <= 1e-4
    assert np.all(info.history[10 : info.converged_at - 1] > 1e-4)
    err = np.linalg.norm(info["x"].numpy() - x_true)
    assert err < np.linalg.norm(y - x_true)
    assert set(info.diagnostics) == {"x", "z0", "z1"}


@pytest.mark.parametrize("iso", [True, False])
def test_tv_objective_matches_jax(rng, iso):
    h = _gauss()
    x_true, y = _problem(rng, h)
    t = topt.TVDeconvolution(S, y, LAM, filt=h, isotropic=iso)
    j = jopt.TVDeconvolution(S, jnp.asarray(y), LAM, filt=h, isotropic=iso)
    np.testing.assert_allclose(
        float(t.objective(torch.from_numpy(x_true))), float(j.objective(jnp.asarray(x_true))), rtol=1e-4
    )


def test_metric_every_leaves_unmeasured_rows_nan(rng):
    h = _gauss()
    _, y = _problem(rng, h)
    every = topt.TVDeconvolution(S, y, LAM, filt=h, max_iter=40, metric_every=3).run_fixed(9)
    dense = topt.TVDeconvolution(S, y, LAM, filt=h, max_iter=40).run_fixed(9)
    hist = every["history"][:9].numpy()
    assert np.isnan(hist[[0, 1, 3, 4, 6, 7]]).all()
    np.testing.assert_allclose(hist[[2, 5, 8]], dense["history"][[2, 5, 8]].numpy(), rtol=1e-6)
    assert torch.equal(every["x"], dense["x"])


def test_run_fixed_does_not_write_a_held_state(rng):
    h = _gauss()
    _, y = _problem(rng, h)
    s = topt.TVDeconvolution(S, y, LAM, filt=h, max_iter=40)
    first = s.run_fixed(5)
    hist = first["history"].clone()
    s.run_fixed(5, state=first)
    assert torch.equal(first["history"].nan_to_num(-1), hist.nan_to_num(-1))


def test_cuda_request_without_cuda_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    y = rng.standard_normal(S).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        topt.TVDeconvolution(S, y, LAM, filt=_gauss(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.Convolve2D(S, _gauss(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tfunc.SquaredL2Loss(S, data=y, device="cuda")


@pytest.mark.parametrize("engine", ["element", "mega", "mega2", "mega3"])
def test_unported_engines_raise(rng, engine):
    """The engines that were not ported before K10-K13 are now: they launch
    CUDA kernels, so asked for on a CPU device they raise as every CUDA
    engine does (tests/test_torch_rank1.py runs their plain versions)."""
    y = rng.standard_normal(S).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        topt.TVDeconvolution(S, y, LAM, filt=_gauss(), stencil=engine)


def test_unported_modes_raise(rng, monkeypatch):
    """Every mode that once raised here now builds: mask mode, the
    large-denoise reroute, a full-rank PSF, and a PDS whose ||K|| is
    unknown (the power iteration sets it: on JAX's start vector, the JAX
    estimate to 1e-5)."""
    y = rng.standard_normal(S).astype(np.float32)
    # mask mode and the large-denoise reroute are ported: they build
    s = topt.TVDeconvolution(S, y, LAM, mask=np.ones(S, np.float32))
    assert (s.mode, s.stencil_mode, s.iters_per_step) == ("mask", "plain", 1)
    big = (2048, 1024)
    s = topt.TVDeconvolution(big, np.zeros(big, np.float32), LAM)
    assert s.mode == "mask" and tuple(s.filt.shape) == (1, 1)
    # a full-rank PSF builds: the FFT Gram, the plain engine on the CPU
    s = topt.TVDeconvolution(S, y, LAM, filt=np.random.default_rng(0).random((5, 5)))
    assert (s.mode, s.stencil_mode, type(s.gram).__name__) == ("conv", "plain", "ConvGram2D")
    for engine in ("megar", "sweep"):  # the conv mode's kernel engines need a CUDA device
        with pytest.raises(ValueError, match="CUDA"):
            topt.TVDeconvolution(S, y, LAM, filt=_gauss(), stencil=engine, device="cpu")
    # the reference's "xla" is the plain engine (tests/test_torch_switches.py); other names raise
    assert topt.TVDeconvolution(S, y, LAM, filt=_gauss(), stencil="xla").stencil_mode == "plain"
    with pytest.raises(ValueError, match="unknown stencil"):
        topt.TVDeconvolution(S, y, LAM, filt=_gauss(), stencil="xla2")
    import jax

    import pycsou_tpu.utils.opnorm as jopn
    import pycsou_tpu_torch.utils.opnorm as topn

    monkeypatch.setattr(topn, "_rand_like", lambda key, shape, dtype, device: torch.from_numpy(
        np.array(jopn._rand_like(jax.random.PRNGKey(key), shape, jnp.float32))).to(device))
    K = tops.Convolve2D(S, _gauss()).replace(_lipschitz=float("inf"))
    p = topt.PDS(S, F=tfunc.SquaredL2Loss(S, data=y), H=tfunc.L1Norm(S), K=K)
    JK = jconv.Convolve2D(S, jnp.asarray(_gauss())).replace(_lipschitz=float("inf"))
    jp = jopt.PDS(S, F=jfunc.SquaredL2Loss(S, data=jnp.asarray(y)), H=jpen.L1Norm(S), K=JK)
    assert np.isfinite(K.lipschitz) and K.lipschitz <= 1 + 1e-5
    assert K.lipschitz == pytest.approx(jp.K.lipschitz, rel=1e-5)
    assert p.tau == pytest.approx(jp.tau, rel=1e-5) and p.sigma == pytest.approx(jp.sigma, rel=1e-5)


def test_near_miss_is_explained(rng, caplog):
    """A PDS one slot away from the pattern runs generically and says why."""
    h = _gauss()
    _, y = _problem(rng, h)
    F = tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, h)
    H = LAM * tfunc.L21Norm((2,) + S, axis=1)
    with caplog.at_level(logging.WARNING, logger="pycsou_tpu_torch.fuse"):
        p = topt.PDS(S, F=F, G=tfunc.NonNegativeOrthant(S), H=H, K=tops.Gradient(S))
    assert p._fused is None
    assert "axis=0" in caplog.text
    note = explain_tv_mismatch(S, F, tfunc.NonNegativeOrthant(S), H, tops.Gradient(S))
    assert note and note.startswith("PDS expression NOT fused")
    # a full-rank PSF fuses, as in the reference (onto the FFT Gram)
    full = tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, np.random.default_rng(0).random((5, 5)))
    p = topt.PDS(S, F=full, G=tfunc.NonNegativeOrthant(S), H=LAM * tfunc.L21Norm((2,) + S, axis=0), K=tops.Gradient(S))
    assert type(p._fused) is topt.TVDeconvolution and type(p._fused.gram) is tops.ConvGram2D
    assert p.run_fixed(3)["x"].shape == S


def test_mode_engine_validation(rng):
    y = rng.standard_normal(S).astype(np.float32)
    m = np.ones(S, np.float32)
    h = _gauss()
    cases = [
        (dict(mask=m, stencil="megar"), "mask mode supports"),
        (dict(mask=m, stencil="megarm"), "mask mode supports"),
        (dict(filt=h, stencil="sweepm"), "conv mode supports"),
        (dict(filt=h, mask=m, stencil="sweepm2"), "combined mode supports"),
        (dict(filt=h, mask=m, stencil="megar"), "combined mode supports"),
        (dict(mask=m, stencil="sweepm"), "CUDA"),
        (dict(filt=h, mask=m, stencil="megarm"), "CUDA"),
        (dict(stencil="sweepm2"), "CUDA"),  # an explicit masked engine reroutes a denoise
        (dict(mask=np.ones((8, 8), np.float32)), "mask shape"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            topt.TVDeconvolution(S, y, LAM, **kw)
    # a full-rank PSF in combined mode builds: the plain engine on the CPU
    # (sweep on the card); megarm refuses it
    s = topt.TVDeconvolution(S, y, LAM, filt=np.random.default_rng(0).random((5, 5)), mask=m)
    assert (s.mode, s.stencil_mode, s.conv.method) == ("combined", "plain", "direct")
    with pytest.raises(ValueError, match="megarm"):
        topt.TVDeconvolution(S, y, LAM, filt=np.random.default_rng(0).random((5, 5)), mask=m,
                             stencil="megarm")
    s = topt.TVDeconvolution(S, y, LAM, filt=h, mask=m)
    assert (s.mode, s.stencil_mode, s.gram) == ("combined", "plain", None)
    assert s.beta == pytest.approx(2.0 * s.conv.lipschitz**2)


def test_near_miss_note_knows_masked_F(rng, caplog):
    """A sampling F (and a sampling F after a convolution) is a supported
    slot: a K-only mismatch blames K, not F."""
    keep = rng.random(S) < 0.5
    for op in (tops.Masking(S, keep), tops.Masking(S, keep) * tops.Convolve2D(S, _gauss())):
        F = tfunc.SquaredL2Loss(op.codim_shape, data=op(torch.ones(S))) * op
        H = LAM * tfunc.L21Norm((2,) + S, axis=0)
        K = tops.Gradient(S, step=2.0)  # the only mismatch
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="pycsou_tpu_torch.fuse"):
            p = topt.PDS(S, F=F, G=tfunc.NonNegativeOrthant(S), H=H, K=K, max_iter=50)
        assert p._fused is None
        notes = [r.message for r in caplog.records if "NOT fused" in r.message]
        assert notes and "steps" in notes[0] and "F is" not in notes[0]
        assert explain_tv_mismatch(S, F, tfunc.NonNegativeOrthant(S), H, K) == notes[0]
