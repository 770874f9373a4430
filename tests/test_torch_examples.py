"""The ten ``examples/torch/`` twins against the JAX package on the CPU.

Each twin's problem (its ``problem()``, cut to a small size where the
reference's would take long here) goes through the twin's solver and
through the JAX modules the reference example uses, built on the same
numpy arrays, for a fixed iteration count: rtol 1e-4 / atol 1e-5 max|x|
(``_close``).  The power iteration takes JAX's start vector and PMYULA
takes the JAX generic chain's noise, monkeypatched in as
``tests/test_torch_opnorm.py`` and ``tests/test_torch_mcmc.py`` do.  Each
twin's ``main()`` runs on the CPU at a small size, prints its quality
figure and engine, and beats its observation; two run as scripts with
``--device cpu``.
"""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.math as jmath
import pycsou_tpu.ops as jops
import pycsou_tpu.ops.sampling as jsamp
import pycsou_tpu.opt as jopt
import pycsou_tpu.utils.opnorm as jopn
from pycsou_tpu.opt.admm import ConsensusADMM as JADMM
from pycsou_tpu.parallel import make_mesh as j_make_mesh
import pycsou_tpu_torch.opt.mcmc as tmcmc
import pycsou_tpu_torch.utils.opnorm as topn
from pycsou_tpu_torch.utils.device import as_tensor, set_default_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    """The CPU, on one thread: these runs are chains of small tensor ops,
    which several threads a test worker only slow down when the workers
    share the machine."""
    set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_default_device(None)


def _twin(name):
    path = os.path.join(REPO, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"twin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, key=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=key)


def _states_close(ts, js, keys):
    for k in keys:
        _close(ts[k], js[k], k)


@pytest.fixture
def jax_start(monkeypatch):
    """The port's power-iteration start vectors become JAX's draws."""
    def draw(key, shape, dtype, device):
        v = jopn._rand_like(jax.random.PRNGKey(key), shape, jnp.complex64 if dtype.is_complex else jnp.float32)
        return torch.from_numpy(np.array(v)).to(dtype=dtype, device=device)

    monkeypatch.setattr(topn, "_rand_like", draw)


def _jax_noise(seed, n, shape):
    """The JAX generic chain's noise: its key split once per sample."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype=jnp.float32)))
    return out


def _jax_tv_pds(y, op, n, lam, nonneg=True, H=None, max_iter=300):
    F = jfunc.SquaredL2Loss(op.codim_shape, data=jnp.asarray(y)) * op
    H = lam * jpen.L21Norm((2, n, n), axis=0) if H is None else H
    G = jfunc.NonNegativeOrthant((n, n)) if nonneg else None
    return jopt.PDS((n, n), F=F, G=G, H=H, K=jops.Gradient((n, n)), max_iter=max_iter)


# -- the TV twins ---------------------------------------------------------------------------


def test_deconv_tv_2048_matches_jax():
    tw = _twin("deconv_tv_2048")
    n = 64
    clean, h, noise = tw.problem(n)
    y = tw.Convolve2D((n, n), h, device=CPU)(as_tensor(clean, CPU)) + as_tensor(noise, CPU)
    t = tw.build(y, h, verbose=None)
    assert t._fused.stencil_mode == "plain"
    j = _jax_tv_pds(y.numpy(), jops.Convolve2D((n, n), jnp.asarray(h)), n, tw.LAM)
    assert j._fused.stencil_mode == "xla"
    _states_close(t.run_fixed(6), j.run_fixed(6), ("x", "z0", "z1"))


def test_motion_deblur_rank2_matches_jax():
    tw = _twin("motion_deblur_rank2")
    n = 64
    clean, h, noise = tw.problem(n)
    us, _ = tw.lowrank_factors(h)
    assert us.shape[1] == 2
    y = tw.Convolve2D((n, n), h, device=CPU)(as_tensor(clean, CPU)) + as_tensor(noise, CPU)
    t = tw.build(y, h, verbose=None)
    j = jopt.TVDeconvolution((n, n), jnp.asarray(y.numpy()), lam=tw.LAM, filt=jnp.asarray(h), nonneg=True,
                             use_pallas=False)
    _states_close(t.run_fixed(6), j.run_fixed(6), ("x", "z0", "z1"))


@pytest.mark.parametrize("which", [0, 1], ids=["isotropic", "anisotropic"])
def test_inpainting_tv_matches_jax(which):
    tw = _twin("inpainting_tv")
    n = 32
    x_true, keep, noise = tw.problem(n)
    M = tw.Masking((n, n), keep, device=CPU)
    y = M(as_tensor(x_true, CPU)) + as_tensor(noise, CPU)
    name, H = tw.penalties(n)[which]
    t = tw.build(M, y, H)
    assert t._fused is not None and t._fused.mask is not None and t._fused.iso == (name == "isotropic")
    jH = [tw.LAM * jpen.L21Norm((2, n, n), axis=0), tw.LAM * jpen.L1Norm((2, n, n))][which]
    j = _jax_tv_pds(y.numpy(), jops.Masking((n, n), keep), n, tw.LAM, H=jH)
    assert j._fused is not None and j._fused.mask is not None
    _states_close(t.run_fixed(6), j.run_fixed(6), ("x", "z0", "z1"))


def test_tv_denoise2d_matches_jax():
    tw = _twin("tv_denoise2d")
    n = 32
    clean, noisy = tw.problem(n)
    t = tw.build(as_tensor(noisy, CPU), verbose=None)
    F = jfunc.SquaredL2Loss((n, n), data=jnp.asarray(noisy))
    j = jopt.PDS((n, n), F=F, H=tw.LAM * jpen.L21Norm((2, n, n), axis=0), K=jops.Gradient((n, n)), max_iter=500)
    _states_close(t.run_fixed(6), j.run_fixed(6), ("x", "z0", "z1"))


# -- the tutorial: PDS, then PMYULA on the JAX noise ----------------------------------------


def test_tutorial_matches_jax(monkeypatch):
    tw = _twin("tutorial")
    shape = (32, 32)
    x_true, psf, noise = tw.problem(shape)
    from pycsou_tpu_torch.ops import Convolve2D

    y = Convolve2D(shape, psf, device=CPU)(as_tensor(x_true, CPU)) + as_tensor(noise, CPU)
    t, F, G = tw.build(y, psf)
    jA = jops.Convolve2D(shape, jnp.asarray(psf))
    jF = jfunc.SquaredL2Loss(shape, data=jnp.asarray(y.numpy())) * jA
    jG = jfunc.NonNegativeOrthant(shape)
    j = jopt.PDS(shape, F=jF, G=jG, H=0.05 * jpen.L21Norm((2,) + shape, axis=0), K=jops.Gradient(shape),
                 max_iter=1000, accuracy_threshold=1e-5)
    np.testing.assert_allclose(F.diff_lipschitz, jF.diff_lipschitz, rtol=1e-6)
    _states_close(t.run_fixed(6), j.run_fixed(6), ("x", "z0", "z1"))

    mc = tw.sampler(F, G)
    jmc = jopt.PMYULA(shape, F=jF, G=jG, max_iter=1500, nb_burnin_iterations=300, thinning_factor=5,
                      pvalues=(0.05, 0.95), accuracy_threshold=0.0)
    assert mc.engine == jmc.engine == ""
    xis = _jax_noise(0, 12, shape)
    monkeypatch.setattr(tmcmc, "normal_noise", lambda seed, n, shape, device: torch.from_numpy(xis[int(n)].copy()))
    _states_close(mc.run_fixed(12), jmc.run_fixed(12), ("x", "mmse_raw", "m2_raw"))


# -- the LASSO, the stacked operators, ADMM -------------------------------------------------


def test_lasso_deconv1d_matches_jax():
    tw = _twin("lasso_deconv1d")
    x_true, h, noise, idx = tw.problem()
    A = tw.Convolve1D((256,), h, device=CPU)
    y = A(as_tensor(x_true, CPU)) + as_tensor(noise, CPU)
    t = tw.build(A, y, verbose=None)
    jA = jops.Convolve1D((256,), jnp.asarray(h))
    np.testing.assert_allclose(A.lipschitz, jA.lipschitz, rtol=1e-6)
    j = jopt.APGD((256,), F=jfunc.SquaredL2Loss((256,), data=jnp.asarray(y.numpy())) * jA,
                  G=tw.LAM * jfunc.L1Norm((256,)), acceleration="CD", max_iter=2000, accuracy_threshold=1e-7)
    _states_close(t.run_fixed(30), j.run_fixed(30), ("x", "x_temp"))


def test_stacked_sparse_lowfreq_matches_jax(jax_start):
    tw = _twin("stacked_sparse_lowfreq")
    n = 256
    c_true, mask, rng = tw.problem(n)
    dct, _, K = tw.build(n, mask, CPU)
    jdct = jops.DCTOperator((n,))
    jK = jops.LinOpVStack([jops.Masking((n,), mask), jops.SubSampling((n,), np.arange(32)) * jdct])
    jK.compute_lipschitz_cst()
    np.testing.assert_allclose(K.lipschitz, jK.lipschitz, rtol=1e-5)
    x_true = dct.adjoint(as_tensor(c_true, CPU))
    y = K(x_true)
    y = y + 0.005 * as_tensor(rng.standard_normal(tuple(y.shape)).astype(np.float32), CPU)
    t = tw.solver_for(K, dct, y, verbose=None)
    j = jopt.APGD((n,), F=jfunc.SquaredL2Loss(jK.codim_shape, data=jnp.asarray(y.numpy())) * jK,
                  G=0.01 * (jfunc.L1Norm((n,)) * jdct), max_iter=4000, accuracy_threshold=1e-9)
    _states_close(t.run_fixed(20), j.run_fixed(20), ("x", "x_temp"))


def test_consensus_admm_3d_matches_jax():
    from pycsou_tpu.ops.conv import CircularConvolve as JCircular
    from pycsou_tpu_torch.parallel import make_mesh

    tw = _twin("consensus_admm_3d")
    shape, S = (32, 32, 32), 8
    x_true, rng = tw.problem(shape)
    h_hats, ys = tw.scenarios(x_true, rng, S, CPU)
    for s in range(S):  # each scenario's transfer and blur against the reference's
        jop = JCircular(shape, jnp.asarray(tw.psf(s)))
        _close(h_hats[s], np.asarray(jop.h_hat), f"h_hat {s}")
        _close(tw.CircularConvolve(shape, tw.psf(s), device=CPU)(as_tensor(x_true, CPU)),
               jop(jnp.asarray(x_true)), f"blur {s}")
    admm = tw.build(shape, h_hats, ys, make_mesh((S,), ("dp",), devices=["cpu"] * S))
    jadmm = JADMM(shape, jnp.asarray(h_hats.numpy()), jnp.asarray(ys), g=jfunc.NonNegativeOrthant(shape), rho=0.5,
                  mesh=j_make_mesh((S,), ("dp",)))
    _close(admm.run(10), jadmm.run(10))


# -- PMYULA on the JAX noise ----------------------------------------------------------------


def test_bayes_uncertainty_mcmc_matches_jax(monkeypatch):
    tw = _twin("bayes_uncertainty_mcmc")
    n = 128
    x_true, h, noise = tw.problem(n)
    A = tw.Convolve1D((n,), h, device=CPU)
    y = A(as_tensor(x_true, CPU)) + as_tensor(noise, CPU)
    t = tw.build(A, y, nb_burnin_iterations=5, n_samples=200)
    jA = jops.Convolve1D((n,), jnp.asarray(h))
    jF = (1.0 / (2 * tw.SIGMA**2)) * (jfunc.SquaredL2Loss((n,), data=jnp.asarray(y.numpy())) * jA)
    j = jopt.PMYULA((n,), F=jF, G=10.0 * jfunc.L1Norm((n,)), nb_burnin_iterations=5, max_iter=200, min_iter=200,
                    accuracy_threshold=0.0, pvalues=(0.025, 0.5, 0.975), seed=0)
    assert t.engine == j.engine == "" and (t.tau, t.gamma) == pytest.approx((j.tau, j.gamma), rel=1e-6)
    xis = _jax_noise(0, 12, (n,))
    monkeypatch.setattr(tmcmc, "normal_noise", lambda seed, k, shape, device: torch.from_numpy(xis[int(k)].copy()))
    ts, js = t.run_fixed(12), j.run_fixed(12)
    scale = float(np.abs(np.asarray(js["x"])).max())
    for k in ("x", "mmse_raw", "m2_raw"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=1e-5 * scale**2, err_msg=k)
    assert int(ts["count"]) == int(js["count"])


# -- RBF fits --------------------------------------------------------------------------------


def test_rbf_interpolation_main_matches_jax(jax_start):
    tw = _twin("rbf_interpolation")
    t_obs, y, centers = tw.problem()
    K = tw.MappedDistanceMatrix(t_obs, centers, tw.Matern(k=2, epsilon=0.08), device=CPU)
    jK = jsamp.MappedDistanceMatrix(t_obs, centers, jmath.Matern(k=2, epsilon=0.08))
    K.compute_lipschitz_cst()
    jK.compute_lipschitz_cst()
    np.testing.assert_allclose(K.lipschitz, jK.lipschitz, rtol=1e-5)
    t = tw.build(K, as_tensor(y, CPU))
    j = jopt.APGD((60,), F=jfunc.SquaredL2Loss((120,), data=jnp.asarray(y)) * jK,
                  G=0.05 * jpen.SquaredL2Norm((60,)), max_iter=2000, accuracy_threshold=1e-8)
    ts, js = t.run_fixed(30), j.run_fixed(30)
    for k in ("x", "x_temp"):  # the Matern matrix's products in another order
        want = np.asarray(js[k])
        np.testing.assert_allclose(ts[k].numpy(), want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_rbf_interpolation_main_large_matches_jax():
    tw = _twin("rbf_interpolation")
    n = 2000
    pts, y, _ = tw.problem_large(n)
    K = tw.MappedDistanceMatrix(pts, pts, tw.Wendland(k=2, epsilon=0.02), backend="sparse", device=CPU)
    jK = jsamp.MappedDistanceMatrix(pts, pts, jmath.Wendland(k=2, epsilon=0.02), backend="sparse")
    assert K._nbr_idx.shape[1] == jK._nbr_idx.shape[1]
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    _close(K(as_tensor(x, CPU)), jK(jnp.asarray(x)))
    K.lipschitz = jK.lipschitz = 1.0
    t = tw.APGD((n,), F=tw.SquaredL2Loss((n,), data=as_tensor(y, CPU)) * K, G=1e-3 * tw.SquaredL2Norm((n,)))
    j = jopt.APGD((n,), F=jfunc.SquaredL2Loss((n,), data=jnp.asarray(y)) * jK, G=1e-3 * jpen.SquaredL2Norm((n,)))
    _states_close(t.run_fixed(20), j.run_fixed(20), ("x", "x_temp"))


# -- each twin's main() on the CPU at a small size ------------------------------------------


MAINS = {
    "deconv_tv_2048": dict(n=64, max_iter=40, verbose=None),
    "motion_deblur_rank2": dict(n=64, max_iter=60, verbose=None),
    "inpainting_tv": dict(n=64, max_iter=3000),
    "tv_denoise2d": dict(n=64, max_iter=200, verbose=None),
    "tutorial": dict(shape=(32, 32), max_iter=1000, mc_iter=400),
    "lasso_deconv1d": dict(max_iter=400, verbose=None),
    "stacked_sparse_lowfreq": dict(n=256, max_iter=400, verbose=None),
    "consensus_admm_3d": dict(n_iter=20),
    "bayes_uncertainty_mcmc": dict(n_samples=700, nb_burnin_iterations=200),
    "rbf_interpolation": dict(max_iter=300),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_twin_main_on_the_cpu(name, capsys):
    out = _twin(name).main(device="cpu", **MAINS[name])
    printed = capsys.readouterr().out
    assert "cpu" in printed and out["engine"]
    if "psnr" in out:
        assert out["psnr"] > out["psnr_observed"], out
    if "err_observed" in out:
        assert out["err"] < out["err_observed"], out
    if name == "stacked_sparse_lowfreq":
        assert out["err"] < 0.5 and 1.0 < out["lipschitz"] < 1.5


def test_rbf_main_large_small_on_the_cpu(capsys):
    out = _twin("rbf_interpolation").main_large(device="cpu", n=3000, max_iter=50)
    assert out["err"] < 0.5 and out["kmax"] > 1
    assert "sparse MDM: n=3000" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["consensus_admm_3d", "lasso_deconv1d"])
def test_twin_runs_as_a_script_on_the_cpu(name):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, os.path.join(REPO, "examples", "torch", f"{name}.py"), "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "rel err" in p.stdout.replace("rel_err", "rel err")
