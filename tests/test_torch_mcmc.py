"""The Bayesian slice of the port on the CPU against the JAX package: K9's
plain version against the Pallas Langevin kernel in interpret mode (streamed
noise), PMYULA against the JAX generic chain with the JAX chain's own noise,
the P^2 quantiles and the MCMC diagnostics, the reference's statistical
checks, and the counter-based noise generator.

Tolerances: rtol/atol 3e-5 for one kernel step (the reference's own bound
for its kernel against the generic update) and 1e-6 for the accumulators
given x+; rtol 1e-4 / atol 1e-5 times max |x| for 12 samples of two chains
(convolutions summed in another order); P^2, ESS and R-hat to rtol 1e-5
(the same float32 arithmetic); the statistical checks keep the
reference's bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.opt as jopt
import pycsou_tpu.utils.diagnostics as jdiag
import pycsou_tpu.utils.stats as jstats
from pycsou_tpu.kernels.langevin import pmyula_mega_step as jax_pmyula
from pycsou_tpu.ops.conv import Convolve2D as JConv
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.opt as topt
import pycsou_tpu_torch.opt.mcmc as tmcmc
import pycsou_tpu_torch.utils.diagnostics as tdiag
import pycsou_tpu_torch.utils.stats as tstats
from pycsou_tpu_torch.kernels.langevin import _philox4x32_10, normal_noise, pmyula_mega_step
from pycsou_tpu_torch.ops import Convolve2D, HomothetyOperator
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


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _psf(K=9):
    ax = np.arange(K) - K // 2
    h = np.outer(np.exp(-(ax**2) / 8.0), np.exp(-(ax**2) / 4.0)).astype(np.float32)
    return h / h.sum()


def _jax_plans(h):
    """The Pallas kernel's rank-1 plans (tests/test_langevin.py _plans)."""
    from pycsou_tpu.kernels.tv import make_mega2_lane_plan, make_mega3_corr_mats, make_mega_band

    gram = JConv(S, h).gram
    C, F = make_mega2_lane_plan(gram.g_cols_taps, S[1])
    Et, Eb = make_mega3_corr_mats(gram.g_rows_E, gram.g_meta[1])
    B = make_mega_band(gram.g_rows_acorr, r=32)
    return [jnp.asarray(a) for a in (B, C, F, Et, Eb)]


@pytest.mark.parametrize("prox_mode,lam", [("none", 0.0), ("nonneg", 0.0), ("l1", 0.03)])
@pytest.mark.parametrize("w", [1.0, 0.0])
def test_pmyula_plain_matches_pallas(rng, prox_mode, lam, w):
    """K9's plain version in stream mode against the Pallas kernel
    (noise_mode='stream', interpret mode) on the same inputs and noise."""
    h = _psf()
    x, atb, m1, xi = (rng.standard_normal(S).astype(np.float32) for _ in range(4))
    m2 = np.abs(rng.standard_normal(S)).astype(np.float32)
    kw = dict(gamma=0.07, tau=0.2, lam=lam, prox_mode=prox_mode)
    jx, jm1, jm2 = jax_pmyula(
        jnp.asarray(x), jnp.asarray(atb), jnp.asarray(m1), jnp.asarray(m2), jnp.zeros((2,), jnp.int32),
        jnp.asarray([w], jnp.float32), *_jax_plans(h), noise_mode="stream", noise=jnp.asarray(xi),
        interpret=True, **kw,
    )
    A = Convolve2D(S, h)
    before = pmyula_mega_step.launches
    tx, tm1, tm2 = pmyula_mega_step(
        _t(x), _t(atb), _t(m1), _t(m2), torch.zeros(2, dtype=torch.int32), torch.tensor([w]),
        A.fwd, A.fwd.adjoint(2.0), noise_mode="stream", noise=_t(xi), **kw,
    )
    assert pmyula_mega_step.launches == before  # plain version on the CPU
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(tm1.numpy(), m1 + w * tx.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm2.numpy(), m2 + w * tx.numpy() ** 2, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm1.numpy(), np.asarray(jm1), rtol=3e-5, atol=3e-5)


def _lsq(pkg_func, conv, y, h, shape=S):
    return pkg_func.SquaredL2Loss(shape, data=y) * conv(shape, h)


def _jax_noise(seed, n, shape):
    """The JAX generic chain's noise: split the key once per sample."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype=jnp.float32)))
    return out


@pytest.mark.parametrize("G", ["l1", "none", "nonneg"])
def test_pmyula_matches_jax_generic_chain(rng, monkeypatch, G):
    """12 samples of the port's generic chain against the JAX generic chain,
    fed the JAX chain's noise (its key split once per sample) through the
    port's one noise function: x, the moments, the count and the metric."""
    h = np.outer(*(2 * [np.exp(-((np.arange(7) - 3) ** 2) / 4.0)])).astype(np.float32)
    h /= h.sum()
    y = np.asarray(JConv(S, jnp.asarray(h)).apply(jnp.abs(jnp.asarray(rng.standard_normal(S), jnp.float32))))
    Gs = {"l1": (0.02 * jpen.L1Norm(S), 0.02 * tfunc.L1Norm(S)), "none": (None, None),
          "nonneg": (jfunc.NonNegativeOrthant(S), tfunc.NonNegativeOrthant(S))}[G]
    kw = dict(seed=7, nb_burnin_iterations=3, max_iter=100)
    j = jopt.PMYULA(S, F=_lsq(jfunc, lambda s, f: JConv(s, jnp.asarray(f)), jnp.asarray(y), h), G=Gs[0], **kw)
    t = topt.PMYULA(S, F=_lsq(tfunc, Convolve2D, y, h), G=Gs[1], **kw)
    assert j.engine == t.engine == "" and (t.tau, t.gamma) == (j.tau, j.gamma)
    xis = _jax_noise(7, 12, S)
    monkeypatch.setattr(tmcmc, "normal_noise", lambda seed, n, shape, device: _t(xis[int(n)]))
    js, ts = j.run_fixed(12), t.run_fixed(12)
    scale = float(np.abs(np.asarray(js["x"])).max())
    for k in ("x", "mmse_raw", "m2_raw"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=1e-5 * scale**2, err_msg=k)
    assert int(ts["count"]) == int(js["count"]) == 12 - 5 and ts["count"].dtype == torch.int32
    np.testing.assert_allclose(ts["history"][:12].numpy(), np.asarray(js["history"])[:12], rtol=1e-4)


@pytest.mark.parametrize("G", ["l1", "nonneg", "none"])
def test_pmyula_fused_matches_generic(rng, G):
    """The fused engine (use_pallas='interpret': K9's plain version) and the
    generic chain draw the same normal_noise(seed, n): equal samples and
    moments on the CPU, within float32 rounding."""
    h = _psf(7)
    y = _t(np.abs(rng.standard_normal(S)))
    Gt = {"l1": 0.02 * tfunc.L1Norm(S), "nonneg": tfunc.NonNegativeOrthant(S), "none": None}[G]
    mk = lambda up: topt.PMYULA(S, F=_lsq(tfunc, Convolve2D, y, h), G=Gt, seed=5,  # noqa: E731
                                nb_burnin_iterations=2, thinning_factor=2, use_pallas=up, max_iter=100)
    fused, generic = mk("interpret"), mk("auto")
    assert fused.engine == "megal" and generic.engine == ""  # auto on the CPU: generic
    assert fused._prox_mode == {"l1": "l1", "nonneg": "nonneg", "none": "none"}[G]
    fs, gs = fused.run_fixed(12), generic.run_fixed(12)
    for k in ("x", "mmse_raw", "m2_raw"):
        np.testing.assert_allclose(fs[k].numpy(), gs[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(fs["count"]) == int(gs["count"]) == 3  # n = 6, 8, 10: past max(burn-in, 4), thinning 2
    np.testing.assert_allclose(fs["history"][:12].numpy(), gs["history"][:12].numpy(), rtol=1e-5)


def test_pmyula_engine_gates(rng):
    """Trackers, a non-matching G and a PSF outside the rank-1 reach keep
    the generic chain under 'auto'; a forced fused engine raises where it
    cannot run (use_pallas=True without CUDA, 'interpret' with trackers)."""
    y = torch.zeros(S)
    F = tfunc.SquaredL2Loss(S, data=y)
    assert topt.PMYULA(S, F=F, pvalues=(0.5,)).engine == ""
    s = topt.PMYULA(S, F=F, use_pallas="interpret")
    assert s.engine == "megal" and s._prox_mode == "none"
    with pytest.raises(ValueError, match="generic chain"):
        topt.PMYULA(S, F=F, use_pallas="interpret", linops=[HomothetyOperator(2.0, S)])
    with pytest.raises(ValueError, match="L1Norm"):
        topt.PMYULA(S, F=F, G=tfunc.SquaredL2Norm(S), use_pallas="interpret")
    wide = np.ones((17, 3), np.float32) / 51  # rank 1, 17 row taps
    with pytest.raises(ValueError, match="row taps"):
        topt.PMYULA(S, F=_lsq(tfunc, Convolve2D, y, wide), use_pallas="interpret")
    full = np.random.default_rng(0).random((5, 5)).astype(np.float32)  # full rank: F matches, the gate refuses
    with pytest.raises(ValueError, match="not rank 1"):
        topt.PMYULA(S, F=_lsq(tfunc, Convolve2D, y, full / full.sum()), use_pallas="interpret")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            topt.PMYULA(S, F=F, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas"):
        topt.PMYULA(S, F=F, use_pallas="xla")


def test_p2_matches_jax(rng):
    """P^2 quantile states after the warm-up and many updates: the same
    markers as the JAX functions on the same samples (rtol 1e-5), and the
    host wrapper's median."""
    samples = rng.standard_normal((300, 3)).astype(np.float32)
    js, ts = jstats.p2_init(0.9, (3,)), tstats.p2_init(0.9, (3,))
    jadd = jax.jit(jstats.p2_add)
    for i, x in enumerate(samples):
        js, ts = jadd(js, jnp.asarray(x)), tstats.p2_add(ts, _t(x))
        if i in (2, 4, 5, 299):
            for k in ("q", "n", "n_des", "buffer"):
                np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, atol=1e-6, err_msg=f"{k} @ {i}")
    assert int(ts["count"]) == 300 and ts["count"].dtype == torch.int32
    np.testing.assert_allclose(tstats.p2_quantile(ts).numpy(), np.quantile(samples, 0.9, axis=0), rtol=0.1)
    p2 = tstats.P2Algorithm(0.5)
    xs = rng.standard_normal(200).astype(np.float32)
    for v in xs:
        p2.add_sample(v)
    assert abs(float(p2.q[0]) - np.median(xs)) < 0.2


def test_diagnostics_match_jax(rng):
    """autocovariance, ESS and split-R-hat on the same chains (one and four
    chains, an AR(1) chain) as the JAX functions."""
    white = rng.standard_normal((4, 500)).astype(np.float32)
    ar = np.zeros(400, np.float32)
    for i in range(1, 400):
        ar[i] = 0.8 * ar[i - 1] + rng.standard_normal()
    for chains in (white, white[0], ar):
        np.testing.assert_allclose(tdiag.autocovariance(chains).numpy(), np.asarray(jdiag.autocovariance(chains)),
                                   rtol=1e-4, atol=1e-5)
        for f in ("effective_sample_size", "split_rhat"):
            np.testing.assert_allclose(float(getattr(tdiag, f)(chains)), float(getattr(jdiag, f)(chains)),
                                       rtol=1e-4, err_msg=f)
    assert float(tdiag.effective_sample_size(white)) > 1000
    assert abs(float(tdiag.split_rhat(white)) - 1.0) < 0.05


def test_pmyula_gaussian():
    """The reference's check: ULA on a Gaussian target, mean and standard
    deviation (gamma-biased) and the median."""
    dim = 16
    mu = 2.0 * torch.ones(dim)
    sampler = topt.PMYULA(
        (dim,), F=0.5 * tfunc.SquaredL2Loss((dim,), data=mu), gamma=0.05, tau=1.0, x0=mu,
        nb_burnin_iterations=500, max_iter=6000, min_iter=6000, accuracy_threshold=0.0,
        pvalues=(0.5,), seed=3,
    )
    out = sampler.solve().iterand
    assert int(out["n_samples"]) > 4000
    assert abs(float(out["mmse"].mean()) - 2.0) < 0.15
    assert abs(float(out["std"].mean()) - 1.0) < 0.2
    assert abs(float(out["quantiles"][0.5].mean()) - 2.0) < 0.25


def test_pmyula_with_prox_linops_and_traces():
    """The reference's prox + linops check (a tracked operator 2x: its
    moments are twice x's, its quartiles ordered), plus scalar traces with
    their ESS and R-hat."""
    dim = 8
    F = 0.5 * tfunc.SquaredL2Loss((dim,), data=torch.zeros(dim))
    sampler = topt.PMYULA(
        (dim,), F=F, G=0.5 * tfunc.L1Norm((dim,)), nb_burnin_iterations=100, max_iter=1500,
        min_iter=1500, accuracy_threshold=0.0, linops=[HomothetyOperator(2.0, (dim,))],
        pvalues=(0.25, 0.75), scalar_fns=[lambda x: x.mean()], seed=0,
    )
    out = sampler.solve().iterand
    np.testing.assert_allclose(out["mmse_linops"][0].numpy(), 2 * out["mmse"].numpy(), rtol=1e-4, atol=1e-5)
    assert torch.all(out["quantiles"][0.25] <= out["quantiles"][0.75])
    assert abs(float(out["mmse"].mean())) < 0.3
    n = int(out["n_samples"])
    assert out["traces"].shape == (1, n) and n == 1500 - 101
    np.testing.assert_allclose(out["traces"][0, -1].item(), float(out["x"].mean()), rtol=1e-6)
    assert out["ess"].shape == (1,) and 1 < float(out["ess"][0]) and abs(float(out["rhat"][0]) - 1) < 0.1


def test_normal_noise():
    """Philox4x32-10 against the generator's published known answers; the
    noise is deterministic per (seed, n), differs across n and seeds, has
    standard normal moments, and ignores PyTorch's global generator."""
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        got = _philox4x32_10(*(torch.tensor([c]) for c in ctr), *(torch.tensor(k) for k in key))
        assert tuple(int(g) for g in got) == want
    shape = (128, 96)
    torch.manual_seed(0)
    a = normal_noise(3, 5, shape, "cpu")
    torch.manual_seed(1)
    assert torch.equal(a, normal_noise(3, torch.tensor(5, dtype=torch.int32), shape, "cpu"))
    assert a.shape == shape and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    assert not torch.equal(a, normal_noise(3, 6, shape, "cpu"))
    assert not torch.equal(a, normal_noise(4, 5, shape, "cpu"))
    z = torch.cat([normal_noise(11, n, shape, "cpu").reshape(-1) for n in range(8)]).double()
    N = z.numel()
    assert abs(float(z.mean())) < 5 / np.sqrt(N)
    assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2 / N)
    assert abs(float((z**3).mean())) < 5 * np.sqrt(15 / N)


def test_pmyula_state_round_trip(rng):
    """A warm JAX PMYULA state (with P^2 states and traces) through
    state_from_numpy: the key is dropped, counters stay int32, lists and
    dicts come across, and the port's chain continues from it."""
    dim = (6, 5)
    y = jnp.asarray(rng.standard_normal(dim), jnp.float32)
    kw = dict(nb_burnin_iterations=2, pvalues=(0.5,), scalar_fns=[lambda x: x.sum()], max_iter=40)
    j = jopt.PMYULA(dim, F=jfunc.SquaredL2Loss(dim, data=y), **kw)
    t = topt.PMYULA(dim, F=tfunc.SquaredL2Loss(dim, data=_t(y)), **kw)
    warm = jax.tree_util.tree_map(np.asarray, j.run_fixed(10))
    ts = state_from_numpy(warm, "cpu")
    assert "key" not in ts and ts["it"] == 10
    assert ts["n"].dtype == ts["count"].dtype == ts["p2_raw"][0]["count"].dtype == torch.int32
    assert int(ts["count"]) == int(warm["count"]) == 10 - 5
    np.testing.assert_array_equal(ts["p2_raw"][0]["q"].numpy(), warm["p2_raw"][0]["q"])
    back = state_to_numpy(ts)
    assert back.keys() == warm.keys() - {"key"}
    np.testing.assert_array_equal(back["traces"], warm["traces"])
    assert back["p2_raw"][0]["count"].dtype == np.int32
    cont = t.run_fixed(6, state=ts)
    assert cont["it"] == 16 and int(cont["count"]) == 11 and int(cont["p2_raw"][0]["count"]) == 11
