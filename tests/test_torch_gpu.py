"""The port's CUDA kernels on the card against their plain PyTorch versions
(marker ``gpu``; each test skips where ``torch.cuda.is_available()`` is
false).  Run on a machine with an H100:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which that machine may
not have; this file imports no JAX and brings its own fixtures.)

Tolerances: 2e-6 relative to the largest magnitude for the images (f32
FMAs against cuDNN's f32 convolutions, different summation order), rtol
1e-5 for the metric partial sums (per-block sums folded in f64).  K6's two
iterations compound the first one's rounding differences into the second:
1e-5 for its images.
"""
import numpy as np
import pytest
import torch

from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    sepconv2d,
    sepconv2d_plain,
    sepgram2d,
    sepgram2d_plain,
)
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_sweep_step_stats,
    tv_pds_sweep_step_stats_plain,
    tv_pds_sweepm2_step,
    tv_pds_sweepm2_step_plain,
    tv_pds_sweepm_step_stats,
    tv_pds_sweepm_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tvr import (
    tv_pds_megar_step,
    tv_pds_megar_step_plain,
    tv_pds_megarm_step,
    tv_pds_megarm_step_plain,
)
from pycsou_tpu_torch.ops import Convolve2D, DownSampling, Gradient, Masking, SubSampling
from pycsou_tpu_torch.ops.conv import lowrank_factors
from pycsou_tpu_torch.opt import PDS, TVDeconvolution

pytestmark = pytest.mark.gpu

KW = dict(tau=0.3, sigma=0.3, rho=0.9, lam=0.05)


@pytest.fixture
def rng():
    return np.random.default_rng(17)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _psf(rng, rank, K0, K1):
    u = rng.standard_normal((K0, rank))
    v = rng.standard_normal((K1, rank))
    h = (u @ v.T).astype(np.float32)
    return h / np.abs(h).sum()


def _close(got, want, rel=2e-6):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * max(scale, 1.0)


@pytest.mark.parametrize("shape", [(5, 7), (100, 130), (256, 384)])
@pytest.mark.parametrize("rank,K0,K1", [(1, 15, 15), (2, 15, 15), (2, 8, 6), (4, 31, 3)])
def test_kernels_match_plain(cuda, rng, shape, rank, K0, K1):
    h = _psf(rng, rank, K0, K1)
    us, vs = lowrank_factors(h)
    f = SepFactors(us, vs, K0 // 2, K1 // 2, cuda)
    a, a2 = f.adjoint(), f.adjoint(2.0)
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(np.abs(rng.standard_normal(shape)))
    atb = t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    before = sepconv2d.launches
    _close(sepconv2d(x, f), sepconv2d_plain(x, f))
    _close(sepconv2d(x, a), sepconv2d_plain(x, a))
    assert sepconv2d.launches == before + 2
    _close(sepgram2d(x, f, a), sepgram2d_plain(x, f, a))
    g = sepgram2d_plain(x, f, a2, atb)
    _close(sepgram2d(x, f, a2, atb), g)
    for iso in (True, False):
        got = tv_pds_sweep_step_stats(x, z0, z1, g, iso=iso, **KW)
        want = tv_pds_sweep_step_stats_plain(x, z0, z1, g, iso=iso, **KW)
        for i in range(3):
            _close(got[i], want[i])
        torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-7)
        got = tv_pds_megar_step(x, z0, z1, atb, f, a2, iso=iso, **KW)
        want = tv_pds_megar_step_plain(x, z0, z1, atb, f, a2, iso=iso, **KW)
        for i in range(3):
            _close(got[i], want[i])
        torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-7)
    torch.cuda.synchronize()


def test_pds_on_the_card_fuses_onto_megar(cuda, rng):
    """The README expression on CUDA tensors: fused onto TVDeconvolution
    with the K4 engine, one K4 launch per iteration, the same iterates as
    the sweep engine (K2 + K3) and as K4's plain version applied step by
    step on the card."""
    S = (192, 256)
    ax = np.arange(15) - 7
    g = np.exp(-(ax**2) / 8.0)
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    y = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(cuda)
    p = PDS(
        S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, h, device=cuda), G=NonNegativeOrthant(S),
        H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=100,
    )
    tv = p._fused
    assert tv.stencil_mode == "megar"
    before = tv_pds_megar_step.launches
    st = p.run_fixed(20)
    assert tv_pds_megar_step.launches == before + 20
    ot = TVDeconvolution(S, y, 0.05, filt=h, stencil="sweep", max_iter=100).run_fixed(20)
    for k in ("x", "z0", "z1"):
        _close(ot[k], st[k], rel=1e-5)
    x, z0, z1 = (torch.zeros(S, device=cuda) for _ in range(3))
    for _ in range(20):
        x, z0, z1, _ = tv_pds_megar_step_plain(
            x, z0, z1, tv.atb, tv.gram.fwd, tv.gram.adj2, tau=tv.tau, sigma=tv.sigma,
            rho=tv.rho, lam=tv.lam, nonneg=tv.nonneg, iso=tv.iso,
        )
    for k, want in (("x", x), ("z0", z0), ("z1", z1)):
        _close(st[k], want, rel=1e-5)


def test_plain_engine_refuses_the_card(cuda, rng):
    """The plain engine is for CPU tensors; on the card it raises."""
    y = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32)).to(cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        TVDeconvolution((32, 48), y, 0.05, filt=np.ones((3, 3), np.float32) / 9, stencil="plain")


def _assert_step_close(got, want, rel):
    for i in range(3):
        _close(got[i], want[i], rel=rel)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "shape", [(1, 40), (2, 33), (33, 2), (5, 7), (33, 130), (100, 130), (256, 384)]
)
@pytest.mark.parametrize("iso,nonneg", [(True, True), (False, False)])
def test_masked_kernels_match_plain(cuda, rng, shape, iso, nonneg):
    """K5 and K6 against their plain versions at ragged shapes and images
    smaller than one tile; the mask takes the counts 0, 1 and 2."""
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(np.abs(rng.standard_normal(shape)))
    m = t(rng.integers(0, 3, shape))
    atb = m * t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    kw = dict(KW, iso=iso, nonneg=nonneg)
    before = (tv_pds_sweepm_step_stats.launches, tv_pds_sweepm2_step.launches)
    _assert_step_close(tv_pds_sweepm_step_stats(x, z0, z1, m, atb, **kw),
                       tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw), 2e-6)
    got = tv_pds_sweepm2_step(x, z0, z1, m, atb, **kw)
    _assert_step_close(got, tv_pds_sweepm2_step_plain(x, z0, z1, m, atb, **kw), 1e-5)
    # chained: a second double step from the first one's output
    _assert_step_close(tv_pds_sweepm2_step(*got[:3], m, atb, **kw),
                       tv_pds_sweepm2_step_plain(*got[:3], m, atb, **kw), 1e-5)
    assert (tv_pds_sweepm_step_stats.launches, tv_pds_sweepm2_step.launches) == (
        before[0] + 1, before[1] + 2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(5, 7), (33, 130), (100, 130), (256, 384)])
@pytest.mark.parametrize("rank,K0,K1", [(1, 15, 15), (2, 9, 7), (4, 31, 3)])
def test_megarm_matches_plain(cuda, rng, shape, rank, K0, K1):
    """K7 (K4 with mask=) against its plain version; K4 is not launched."""
    h = _psf(rng, rank, K0, K1)
    us, vs = lowrank_factors(h)
    f = SepFactors(us, vs, K0 // 2, K1 // 2, cuda)
    a2 = f.adjoint(2.0)
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(np.abs(rng.standard_normal(shape)))
    m = t(rng.integers(0, 3, shape))
    atb = t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    before = (tv_pds_megar_step.launches, tv_pds_megarm_step.launches)
    for iso in (True, False):
        _assert_step_close(tv_pds_megar_step(x, z0, z1, atb, f, a2, iso=iso, mask=m, **KW),
                           tv_pds_megarm_step_plain(x, z0, z1, m, atb, f, a2, iso=iso, **KW), 2e-6)
    assert (tv_pds_megar_step.launches, tv_pds_megarm_step.launches) == (before[0], before[1] + 2)
    torch.cuda.synchronize()


def _masked_pds(kind, S, y, cuda, h=None):
    keep = np.random.default_rng(5).random(S) < 0.7
    ops = {
        "masking": lambda: Masking(S, keep, device=cuda),
        "downsampling": lambda: DownSampling(S, 2),
        "subsampling": lambda: SubSampling(S, np.random.default_rng(6).integers(0, S[0] * S[1], S[0] * S[1] // 2), device=cuda),
        "blurred": lambda: Masking(S, keep, device=cuda) * Convolve2D(S, h, device=cuda),
    }
    op = ops[kind]()
    data = op(y)
    return PDS(S, F=SquaredL2Loss(op.codim_shape, data=data) * op, G=NonNegativeOrthant(S),
               H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=100)


@pytest.mark.parametrize("kind,engine", [("masking", "sweepm2"), ("downsampling", "sweepm2"),
                                         ("subsampling", "sweepm2"), ("blurred", "megarm")])
def test_masked_pds_on_the_card(cuda, rng, kind, engine):
    """The masked PDS expressions fuse onto the expected engine on the card,
    launch only its kernel, and give the plain versions' iterates."""
    S = (96, 160)
    ax = np.arange(9) - 4
    g = np.exp(-(ax**2) / 4.0)
    h = (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32)
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    p = _masked_pds(kind, S, y, cuda, h)
    tv = p._fused
    assert tv.stencil_mode == engine and p.iters_per_step == (2 if engine == "sweepm2" else 1)
    counter = tv_pds_sweepm2_step if engine == "sweepm2" else tv_pds_megarm_step
    others = [c for c in (tv_pds_sweepm2_step, tv_pds_sweepm_step_stats, tv_pds_megarm_step,
                          tv_pds_megar_step, tv_pds_sweep_step_stats) if c is not counter]
    before = [c.launches for c in others]
    n0 = counter.launches
    st = p.run_fixed(10)
    assert st["it"] == 10
    assert counter.launches == n0 + (5 if engine == "sweepm2" else 10)
    assert [c.launches for c in others] == before
    x, z0, z1 = (torch.zeros(S, device=cuda) for _ in range(3))
    kw = dict(tau=tv.tau, sigma=tv.sigma, rho=tv.rho, lam=tv.lam, nonneg=tv.nonneg, iso=tv.iso)
    for _ in range(10):
        if engine == "sweepm2":
            x, z0, z1, _ = tv_pds_sweepm_step_stats_plain(x, z0, z1, tv.mask, tv.atb, **kw)
        else:
            x, z0, z1, _ = tv_pds_megarm_step_plain(x, z0, z1, tv.mask, tv.atb, tv.conv.fwd,
                                                    tv.conv.fwd.adjoint(2.0), **kw)
    for k, want in (("x", x), ("z0", z0), ("z1", z1)):
        _close(st[k], want, rel=1e-5)


def test_large_denoise_on_the_card(cuda, rng):
    """Denoising at 2**21 pixels runs on K6 (the reference's reroute), and
    the same problem by CPS on K6 too."""
    S = (2048, 1024)
    y = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(cuda)
    H = 0.05 * L21Norm((2,) + S, axis=0)
    p = PDS(S, F=SquaredL2Loss(S, data=y), H=H, K=Gradient(S), max_iter=100)
    assert p._fused.stencil_mode == "sweepm2" and p._fused.mode == "mask"
    n0 = tv_pds_sweepm2_step.launches
    p.run_fixed(6)
    assert tv_pds_sweepm2_step.launches == n0 + 3
    from pycsou_tpu_torch.opt import CPS

    c = CPS(S, G=SquaredL2Loss(S, data=y), H=H, K=Gradient(S), max_iter=100)
    assert c._fused.stencil_mode == "sweepm2"
    c.run_fixed(6)
    assert tv_pds_sweepm2_step.launches == n0 + 6
    torch.cuda.synchronize()
