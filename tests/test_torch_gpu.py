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
1e-5 for its images.  K9 in prng mode: 1e-5 (its noise comes from the
card's logf/cosf, the plain version's from torch.log/torch.cos).
"""
import numpy as np
import pytest
import torch

from pycsou_tpu_torch.func import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    sepconv2d,
    sepconv2d_plain,
    sepgram2d,
    sepgram2d_plain,
)
from pycsou_tpu_torch.kernels.fista import lasso_fista_step, lasso_fista_step_plain
from pycsou_tpu_torch.kernels.langevin import normal_noise, pmyula_mega_step, pmyula_mega_step_plain
from pycsou_tpu_torch.kernels.band import gram_band_cols
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_mega2_step,
    tv_pds_mega2_step_plain,
    tv_pds_mega3_step,
    tv_pds_mega3_step_plain,
    tv_pds_mega_step,
    tv_pds_mega_step_plain,
    tv_pds_stencil_step,
    tv_pds_stencil_step_plain,
    tv_pds_sweep_step_stats,
    tv_pds_sweep_step_stats_plain,
    tv_pds_sweepm2_step,
    tv_pds_sweepm2_step_plain,
    tv_pds_sweepm_step_stats,
    tv_pds_sweepm_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_mega2_shard_step,
    tv_pds_mega2_shard_step_plain,
    tv_pds_sweep_shard_step,
    tv_pds_sweep_shard_step_plain,
)
from pycsou_tpu_torch.kernels.sepgram import sepgram_apply, sepgram_apply_plain
from pycsou_tpu_torch.kernels.tvr import (
    HALO_COLS,
    tv_pds_megar_shard2d_step,
    tv_pds_megar_shard2d_step_plain,
    tv_pds_megar_shard_step,
    tv_pds_megar_shard_step_plain,
    tv_pds_megar_step,
    tv_pds_megar_step_plain,
    tv_pds_megarm_step,
    tv_pds_megarm_step_plain,
)
from pycsou_tpu_torch.parallel import (
    DistributedTVDeconv2D,
    Spatial2DTVDeconv2D,
    halo_extend,
    halo_extend_2d,
    halos,
    halos_2d,
    lane_extend,
    make_mesh,
)
from pycsou_tpu_torch.ops import Convolve2D, ConvGram2D, DownSampling, Gradient, Masking, SubSampling
from pycsou_tpu_torch.ops.conv import lowrank_factors
from pycsou_tpu_torch.opt import APGD, PDS, PMYULA, TVDeconvolution

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
    """The README expression on CUDA tensors with a rank-2 PSF (a rank-1 PSF
    takes mega3, test_rank1_engines_on_the_card): fused onto
    TVDeconvolution with the K4 engine, one K4 launch per iteration, the
    same iterates as the sweep engine (K2 + K3) and as K4's plain version
    applied step by step on the card."""
    S = (192, 256)
    ax = np.arange(15) - 7
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h = (np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))).astype(np.float32)
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


# K6's 32 x 64 tiles: heights and widths under one tile, about one tile's
# edge and about two (the last tiles shifted back to the edge), W % 4 != 0
# (rows off 16 bytes); H 97 and 130 and W 130 and 131 put tiles just inside
# and just outside the inner tiles that make no edge test.
@pytest.mark.parametrize("H", [1, 2, 31, 33, 34, 35, 97, 130])
@pytest.mark.parametrize("W", [3, 5, 63, 65, 67, 130, 131])
@pytest.mark.parametrize("iso,nonneg", [(True, True), (False, False)])
def test_sweepm2_tiles_match_plain(cuda, rng, H, W, iso, nonneg):
    """K6 against its plain version across its tiles' edges, on images that
    start on a 16-byte boundary and on images that start one float past one
    (every row's chunks then off 16 bytes); each launched twice on the same
    inputs bit for bit the same (the partial sums fold in a fixed order),
    and a second double step chained from the first one's output.  The mask
    takes the counts 0, 1 and 2."""
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731

    def off(a):  # the same image one float past a 16-byte boundary
        v = a.new_empty(a.numel() + 1)[1:].view(a.shape)
        v.copy_(a)
        return v

    x = t(np.abs(rng.standard_normal((H, W))))
    m = t(rng.integers(0, 3, (H, W)))
    atb = m * t(rng.standard_normal((H, W)))
    z0, z1 = t(0.01 * rng.standard_normal((H, W))), t(0.01 * rng.standard_normal((H, W)))
    kw = dict(KW, iso=iso, nonneg=nonneg)
    before = tv_pds_sweepm2_step.launches
    for images in ((x, z0, z1, m, atb), tuple(off(a) for a in (x, z0, z1, m, atb))):
        assert images[0].data_ptr() % 16 == (0 if images[0] is x else 4)
        got = tv_pds_sweepm2_step(*images, **kw)
        for a, b in zip(got, tv_pds_sweepm2_step(*images, **kw)):
            assert torch.equal(a, b)
        _assert_step_close(got, tv_pds_sweepm2_step_plain(*images, **kw), 1e-5)
        _assert_step_close(tv_pds_sweepm2_step(*got[:3], *images[3:], **kw),
                           tv_pds_sweepm2_step_plain(*got[:3], *images[3:], **kw), 1e-5)
    assert tv_pds_sweepm2_step.launches == before + 6
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


RAGGED = [(1, 40), (2, 33), (33, 2), (5, 7), (33, 130), (100, 130), (256, 384)]


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("rank,K0,K1", [(1, 15, 15), (2, 9, 7), (4, 31, 3)])
def test_fista_kernel_matches_plain(cuda, rng, shape, rank, K0, K1):
    """K8 against its plain version at ragged shapes and images smaller than
    one tile, both prox modes, a momentum of 0.3 from a device scalar."""
    h = _psf(rng, rank, K0, K1)
    us, vs = lowrank_factors(h)
    f = SepFactors(us, vs, K0 // 2, K1 // 2, cuda)
    a2 = f.adjoint(2.0)
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    v, xp, atb = (t(rng.standard_normal(shape)) for _ in range(3))
    mom = torch.tensor([0.3], device=cuda)
    before = lasso_fista_step.launches
    for nonneg in (False, True):
        got = lasso_fista_step(v, xp, atb, mom, f, a2, tau=0.3, lam=0.05, nonneg=nonneg)
        want = lasso_fista_step_plain(v, xp, atb, mom.reshape(()), f, a2, tau=0.3, lam=0.05, nonneg=nonneg)
        _close(got[0], want[0])
        _close(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-7)
    assert lasso_fista_step.launches == before + 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("rank,K0,K1", [(1, 15, 15), (2, 9, 7), (4, 31, 3)])
def test_pmyula_kernel_matches_plain(cuda, rng, shape, rank, K0, K1):
    """K9 against its plain version at ragged shapes, every prox mode, w 0
    and 1, streamed noise and noise drawn in the kernel."""
    h = _psf(rng, rank, K0, K1)
    us, vs = lowrank_factors(h)
    f = SepFactors(us, vs, K0 // 2, K1 // 2, cuda)
    a2 = f.adjoint(2.0)
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x, atb, m1, xi = (t(rng.standard_normal(shape)) for _ in range(4))
    m2 = t(np.abs(rng.standard_normal(shape)))
    si = torch.tensor([7, 123], dtype=torch.int32, device=cuda)
    before = pmyula_mega_step.launches
    for prox_mode in ("none", "nonneg", "l1"):
        for w in (0.0, 1.0):
            wf = torch.tensor([w], device=cuda)
            kw = dict(gamma=0.07, tau=0.2, lam=0.03, prox_mode=prox_mode)
            got = pmyula_mega_step(x, atb, m1, m2, si, wf, f, a2, noise_mode="stream", noise=xi, **kw)
            want = pmyula_mega_step_plain(x, atb, m1, m2, si, wf, f, a2, noise_mode="stream", noise=xi, **kw)
            for g, wv in zip(got, want):
                _close(g, wv)
            got = pmyula_mega_step(x, atb, m1, m2, si, wf, f, a2, **kw)
            want = pmyula_mega_step_plain(x, atb, m1, m2, si, wf, f, a2, **kw)
            for g, wv in zip(got, want):
                _close(g, wv, rel=1e-5)
    assert pmyula_mega_step.launches == before + 12
    torch.cuda.synchronize()


@pytest.mark.parametrize("seed,n", [(0, 0), (3, 21), (2**31 - 1, 2**20 + 5)])
def test_pmyula_prng_is_normal_noise(cuda, seed, n):
    """K9's in-kernel noise is normal_noise(seed, n): with x = atb = 0, a 1x1
    PSF, no prox and gamma = 1/2 (sqrt(2 gamma) = 1), x+ is the noise."""
    S = (257, 300)
    f = SepFactors(np.ones((1, 1)), np.ones((1, 1)), 0, 0, cuda)
    z = torch.zeros(S, device=cuda)
    si = torch.tensor([seed, n], dtype=torch.int32, device=cuda)
    got, _, _ = pmyula_mega_step(z, z, z, z, si, torch.zeros(1, device=cuda), f, f.adjoint(2.0),
                                 gamma=0.5, tau=1.0)
    want = normal_noise(seed, n, S, cuda)
    assert float((got - want).abs().max()) <= 1e-5
    assert bool(torch.isfinite(got).all())


def _gauss(k=15, s=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    return (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32)


def test_apgd_on_the_card_fuses_onto_megaf(cuda, rng):
    """APGD on the LASSO on CUDA tensors: fused onto LassoDeconvolution with
    the K8 engine, one K8 launch per iteration and no other kernel, the
    generic chain's iterates (K2 gradient), and K8's plain version applied
    step by step on the card."""
    S = (192, 256)
    h = _gauss()
    y = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(cuda)
    mk = lambda **kw: APGD(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, h, device=cuda),  # noqa: E731
                           G=0.01 * L1Norm(S), max_iter=100, **kw)
    p = mk()
    assert p._fused.engine == "megaf"
    others = [tv_pds_megar_step, tv_pds_sweepm2_step, sepgram2d, sepconv2d, pmyula_mega_step]
    before, k8 = [c.launches for c in others], lasso_fista_step.launches
    st = p.run_fixed(20)
    assert lasso_fista_step.launches == k8 + 20 and [c.launches for c in others] == before
    gs = mk(fuse=False).run_fixed(20)
    for k in ("x", "x_temp"):
        _close(st[k], gs[k], rel=1e-5)
    ls = p._fused
    v, xp, t_, n = (torch.zeros(S, device=cuda), torch.zeros(S, device=cuda),
                    torch.ones((), device=cuda), torch.zeros((), dtype=torch.int32, device=cuda))
    from pycsou_tpu_torch.opt.lasso import momentum

    for _ in range(20):
        a, t_ = momentum(ls.acceleration, ls.d, t_, n)
        xp, v, _ = lasso_fista_step_plain(v, xp, ls.atb, a, ls.gram.fwd, ls.gram.adj2, tau=ls.tau, lam=ls.lam)
        n = n + 1
    _close(st["x_temp"], xp, rel=1e-5)
    _close(st["x"], v, rel=1e-5)


def test_pmyula_on_the_card_runs_megal(cuda, rng):
    """PMYULA on CUDA tensors runs the K9 engine: one K9 launch per sample
    and no other kernel, and the generic chain's samples (K2 gradient, the
    same Philox noise drawn by normal_noise)."""
    S = (160, 192)
    h = _gauss()
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    mk = lambda up: PMYULA(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, h, device=cuda),  # noqa: E731
                           G=0.01 * L1Norm(S), seed=3, nb_burnin_iterations=2, use_pallas=up, max_iter=100)
    s = mk("auto")
    assert s.engine == "megal" and s._prox_mode == "l1"
    others = [tv_pds_megar_step, lasso_fista_step, sepgram2d, sepconv2d]
    before, k9 = [c.launches for c in others], pmyula_mega_step.launches
    st = s.run_fixed(8)
    assert pmyula_mega_step.launches == k9 + 8 and [c.launches for c in others] == before
    g = mk(False)
    assert g.engine == ""
    gs = g.run_fixed(8)
    for k in ("x", "mmse_raw", "m2_raw"):
        _close(st[k], gs[k], rel=1e-5)
    assert int(st["count"]) == int(gs["count"]) == 3


def _rank1_psf(K0, K1):
    a0, a1 = np.arange(K0) - K0 // 2, np.arange(K1) - K1 // 2
    h = np.outer(np.exp(-(a0**2) / 8.0), np.exp(-(a1**2) / 3.4))
    return (h / h.sum()).astype(np.float32)


@pytest.mark.parametrize("shape,K0,K1", [((48, 50), 15, 15), ((100, 130), 15, 15), ((256, 384), 15, 15),
                                         ((100, 130), 9, 4), ((33, 130), 5, 11), ((7, 9), 1, 1),
                                         ((130, 70), 16, 3)])
@pytest.mark.parametrize("iso,nonneg", [(True, True), (False, False)])
def test_rank1_kernels_match_plain(cuda, rng, shape, K0, K1, iso, nonneg):
    """K10-K13 against their plain versions at ragged shapes (the shifted
    last tile, images smaller than one tile, the edge corrections on both
    axes); K10 twice in a row, as K6."""
    gram = Convolve2D(shape, _rank1_psf(K0, K1), device=cuda).gram
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(np.abs(rng.standard_normal(shape)))
    atb = t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    kw = dict(KW, iso=iso, nonneg=nonneg)
    counters = (tv_pds_mega3_step, tv_pds_mega2_step, tv_pds_mega_step, tv_pds_stencil_step)
    before = [c.launches for c in counters]
    _assert_step_close(tv_pds_mega2_step(x, z0, z1, atb, gram, **kw),
                       tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw), 2e-6)
    got = tv_pds_mega3_step(x, z0, z1, atb, gram, **kw)
    _assert_step_close(got, tv_pds_mega3_step_plain(x, z0, z1, atb, gram, **kw), 1e-5)
    _assert_step_close(tv_pds_mega3_step(*got[:3], atb, gram, **kw),
                       tv_pds_mega3_step_plain(*got[:3], atb, gram, **kw), 1e-5)
    z = torch.stack([z0, z1])
    z[0, -1] = 0.0
    z[1, :, -1] = 0.0
    w = gram_band_cols(x, gram.band_plans()[1]).contiguous()
    for a, b in zip(tv_pds_mega_step(x, z, w, atb, gram, **kw), tv_pds_mega_step_plain(x, z, w, atb, gram, **kw)):
        _close(a, b)
    for a, b in zip(tv_pds_stencil_step(x, z, atb, **kw), tv_pds_stencil_step_plain(x, z, atb, **kw)):
        _close(a, b)
    assert [c.launches for c in counters] == [before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 1]
    torch.cuda.synchronize()


# K11's and K12's tiles are 32 x 64 output pixels staged in shared memory
# (16-byte copies where a row allows, 4-byte ones elsewhere), the last row
# and column tile shifted back to end on the image's edge.  These shapes
# cross their edges: H 3 (the least the rank-1 plan takes: H >= 3 taps), 31,
# 32, 33 and 65; W 63, 64, 65, 130, 4095 and 4096; W % 4 != 0 and H W % 4 !=
# 0 (K12's second dual starts off 16 bytes); an image under one tile; each
# padded reach R 0, 4, 8, 15 with row and column taps of other counts.
RANK1_TILE_CASES = [((3, 4096), 1, 16), ((3, 63), 1, 5), ((31, 4095), 9, 3), ((32, 64), 5, 1),
                    ((33, 65), 3, 16), ((65, 130), 16, 9), ((7, 9), 1, 1), ((65, 4096), 1, 1),
                    ((33, 130), 9, 4), ((32, 4095), 5, 9), ((65, 63), 9, 5), ((31, 65), 1, 5),
                    ((65, 4095), 16, 3), ((3, 130), 1, 1)]


@pytest.mark.parametrize("shape,K0,K1", RANK1_TILE_CASES)
@pytest.mark.parametrize("iso,nonneg", [(True, True), (False, False)])
def test_rank1_tiles_match_plain(cuda, rng, shape, K0, K1, iso, nonneg):
    """K11 and K12 against their plain versions across their tiles' edges
    (the limits of test_rank1_kernels_match_plain), each launched twice on
    the same inputs bit for bit the same, and K14 on a one-shard mesh (the
    whole image, zero halos) bit for bit K11."""
    H, W = shape
    gram = Convolve2D(shape, _rank1_psf(K0, K1), device=cuda).gram
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(np.abs(rng.standard_normal(shape)))
    atb = t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    kw = dict(KW, iso=iso, nonneg=nonneg)
    before = (tv_pds_mega2_step.launches, tv_pds_mega_step.launches)
    got = tv_pds_mega2_step(x, z0, z1, atb, gram, **kw)
    for a, b in zip(got, tv_pds_mega2_step(x, z0, z1, atb, gram, **kw)):
        assert torch.equal(a, b)
    _assert_step_close(got, tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw), 2e-6)
    pad = torch.cat([atb.new_zeros((16, W)), atb, atb.new_zeros((16, W))])
    halos0 = tuple(torch.zeros((16, W), device=cuda) for _ in range(6))
    for a, b in zip(tv_pds_mega2_shard_step(x, z0, z1, pad, halos0, gram, -16, H_global=H, **kw), got):
        assert torch.equal(a, b)
    z = torch.stack([z0, z1])
    z[0, -1] = 0.0
    z[1, :, -1] = 0.0
    w = gram_band_cols(x, gram.band_plans()[1]).contiguous()
    out = tv_pds_mega_step(x, z, w, atb, gram, **kw)
    for a, b in zip(out, tv_pds_mega_step(x, z, w, atb, gram, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(out, tv_pds_mega_step_plain(x, z, w, atb, gram, **kw)):
        _close(a, b)
    assert (tv_pds_mega2_step.launches, tv_pds_mega_step.launches) == (before[0] + 2, before[1] + 2)
    torch.cuda.synchronize()


# K10's strip walker: 63-column strips (the last shifted back to end on the
# image's edge) and, at these sizes, segments of 32 rows, so these shapes
# cross every boundary of the walk: W = 63 -+ 1, 63 + 2, 2 * 63 + 1 and 2 *
# 63 + 3, H = 32 -+ 1 and 2 * 32 -+ 1, widths and heights no multiple of
# either, each padded reach 0, 4, 8, 15.  The pipelined walker's own:
# segments shorter than its depth (stage 1's two steps of fill, then stage
# 2 one step behind: H 100, 50 and 97 end on segments of 4, 18 and 1 rows,
# walked from earlier rows so that the bottom corrections' rows are made),
# the last step of a segment (H = 32 m + 1), the strip shifted back at a
# ragged edge for each padded reach (W 200, 131, 197, 195), H < 2R + 2 for
# R 4, 8 and 15, widths on and off 16-byte rows (16-byte copies where a
# row allows them, 4-byte ones elsewhere), and every slot of the 64-row
# rings with their mirrored rows (H 161).  Last, the benchmark cells' sizes
# with their 15 x 15 Gaussian PSF (sigma 2): 33 strips of 512-row segments
# or 66 of 2048-row ones, one block an SM, 132 in all.
@pytest.mark.parametrize("shape,K0,K1", [((45, 63), 15, 15), ((65, 65), 15, 15), ((63, 129), 15, 15),
                                         ((33, 250), 5, 5), ((31, 130), 9, 9), ((30, 65), 9, 16),
                                         ((7, 9), 1, 1), ((100, 301), 9, 4), ((130, 70), 16, 3),
                                         ((200, 64), 1, 1), ((100, 128), 15, 15), ((130, 132), 16, 3),
                                         ((40, 200), 1, 1), ((130, 192), 1, 1),
                                         ((100, 50), 15, 15), ((50, 60), 15, 15), ((97, 64), 9, 9),
                                         ((113, 65), 5, 16), ((70, 200), 1, 1), ((70, 131), 5, 5),
                                         ((70, 197), 9, 9), ((70, 195), 16, 16), ((20, 130), 3, 16),
                                         ((9, 100), 3, 5), ((12, 70), 3, 9), ((3, 64), 1, 16),
                                         ((161, 129), 16, 16), ((45, 62), 15, 15), ((45, 127), 9, 9),
                                         ((2048, 2048), "gauss", 15), ((4096, 4096), "gauss", 15)])
@pytest.mark.parametrize("iso,nonneg", [(True, True), (False, False)])
def test_mega3_walker_matches_plain(cuda, rng, shape, K0, K1, iso, nonneg):
    """K10 against its plain version twice in a row (the second step from
    the first's outputs), partial sums within rtol 1e-5, and two launches on
    the same inputs bit for bit the same.  K0 "gauss" is the K1 x K1
    Gaussian of sigma 2."""
    if K0 == "gauss":
        a = np.arange(K1) - K1 // 2
        g = np.exp(-(a[:, None] ** 2 + a[None, :] ** 2) / (2 * 2.0**2))
        psf = (g / g.sum()).astype(np.float32)
    else:
        psf = _rank1_psf(K0, K1)
    gram = Convolve2D(shape, psf, device=cuda).gram
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(np.abs(rng.standard_normal(shape)))
    atb = t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    kw = dict(KW, iso=iso, nonneg=nonneg)
    got = tv_pds_mega3_step(x, z0, z1, atb, gram, **kw)
    _assert_step_close(got, tv_pds_mega3_step_plain(x, z0, z1, atb, gram, **kw), 1e-5)
    again = tv_pds_mega3_step(x, z0, z1, atb, gram, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _assert_step_close(tv_pds_mega3_step(*got[:3], atb, gram, **kw),
                       tv_pds_mega3_step_plain(*got[:3], atb, gram, **kw), 1e-5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("engine", ["mega3", "mega2", "mega", "element"])
def test_rank1_engines_on_the_card(cuda, rng, engine):
    """The README expression with a rank-1 PSF fuses onto mega3 on the card;
    each rank-1 engine launches only its kernels (element: K2 + K13) and
    agrees with megar after 6 iterations."""
    S = (192, 256)
    h = _gauss()
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    p = PDS(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, h, device=cuda), G=NonNegativeOrthant(S),
            H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=100)
    assert p._fused.stencil_mode == "mega3" and p.iters_per_step == 2
    ref = TVDeconvolution(S, y, 0.05, filt=h, stencil="megar", max_iter=100).run_fixed(6)
    counters = {"mega3": tv_pds_mega3_step, "mega2": tv_pds_mega2_step, "mega": tv_pds_mega_step,
                "element": tv_pds_stencil_step}
    all_counters = list(counters.values()) + [tv_pds_megar_step, sepgram2d, tv_pds_sweep_step_stats]
    before = [c.launches for c in all_counters]
    st = TVDeconvolution(S, y, 0.05, filt=h, stencil=engine, max_iter=100).run_fixed(6)
    want = {counters[engine]: 3 if engine == "mega3" else 6}
    if engine == "element":
        want[sepgram2d] = 6
    assert [c.launches - b for c, b in zip(all_counters, before)] == [want.get(c, 0) for c in all_counters]
    assert ("_stats" in st) == (engine in ("mega3", "mega2"))
    for k in ("x", "z0", "z1"):
        _close(st[k], ref[k], rel=1e-4)


def test_mega3_bookkeeping_on_the_card(cuda, rng):
    """mega3 on the card: run_fixed(odd n) runs n + 1 iterations in (n + 1)
    / 2 launches, the odd history rows stay NaN, and the iterates are those
    of K11's plain version step by step."""
    S = (160, 224)
    h = _gauss(9, 1.5)
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    s = TVDeconvolution(S, y, 0.05, filt=h, max_iter=100)
    assert s.stencil_mode == "mega3" and s.iters_per_step == 2
    n0 = tv_pds_mega3_step.launches
    st = s.run_fixed(7)
    assert st["it"] == 8 and tv_pds_mega3_step.launches == n0 + 4
    hist = st["history"][:8].cpu().numpy()
    assert np.isnan(hist[0::2]).all() and np.isfinite(hist[1::2]).all()
    x, z0, z1 = (torch.zeros(S, device=cuda) for _ in range(3))
    kw = dict(tau=s.tau, sigma=s.sigma, rho=s.rho, lam=s.lam, nonneg=s.nonneg, iso=s.iso)
    for _ in range(8):
        x, z0, z1, _ = tv_pds_mega2_step_plain(x, z0, z1, s.atb, s.gram, **kw)
    for k, want in (("x", x), ("z0", z0), ("z1", z1)):
        _close(st[k], want, rel=1e-5)


def test_entry_points_default_to_the_card(cuda):
    """numpy inputs and no device=: the port runs on the card; small
    denoising takes the conv mode's identity PSF and mega3."""
    c = Convolve2D((64, 64), np.ones((3, 3)))
    assert c.device.type == "cuda" and c.apply(torch.ones((64, 64), device=cuda)).device.type == "cuda"
    y = np.abs(np.random.default_rng(0).standard_normal((96, 128))).astype(np.float32)
    p = PDS((96, 128), F=SquaredL2Loss((96, 128), data=y), G=NonNegativeOrthant((96, 128)),
            H=0.05 * L21Norm((2, 96, 128), axis=0), K=Gradient((96, 128)), max_iter=100)
    assert p._fused.mode == "conv" and p._fused.stencil_mode == "mega3"
    assert p.run_fixed(4)["x"].device.type == "cuda"


# -- the row-shard kernels (K14-K16) and DistributedTVDeconv2D -------------------


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("shape,K0,K1", [((128, 130), 15, 15), ((256, 96), 9, 4), ((96, 33), 5, 5)])
def test_shard_kernels_match_plain(cuda, rng, P, shape, K0, K1):
    """K14 (rank 1), K15 (rank 2) and K16 on every shard of P on one card,
    halos from the exchange, against their plain versions; each launches
    once a shard."""
    H, W = shape
    h = H // P
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x, atb, g = t(np.abs(rng.standard_normal(shape))), t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    xs, as_, gs, z0s, z1s = ([v[i * h : (i + 1) * h] for i in range(P)] for v in (x, atb, g, z0, z1))
    kw = dict(KW, H_global=H)
    gram = Convolve2D(shape, _rank1_psf(K0, K1), device=cuda).gram
    f = Convolve2D(shape, _psf(rng, 2, K0, K1), device=cuda).fwd
    a2 = f.adjoint(2.0)
    counters = (tv_pds_mega2_shard_step, tv_pds_megar_shard_step, tv_pds_sweep_shard_step)
    before = [c.launches for c in counters]
    for R in (1, 3):
        for i, hl in enumerate(halos((xs, gs, z0s, z1s), R)):
            _assert_step_close(tv_pds_sweep_shard_step(xs[i], gs[i], z0s[i], z1s[i], hl, i * h - R, **kw),
                               tv_pds_sweep_shard_step_plain(xs[i], gs[i], z0s[i], z1s[i], hl, i * h - R, **kw), 2e-6)
    R = max(K0, K1)  # K14 reads the padded reach + 1 <= 16 rows, K15 K0 rows
    R1 = {1: 1, 5: 5, 9: 9, 15: 16}[max(K0, K1)]
    ext, ext1 = halo_extend(as_, R), halo_extend(as_, R1)
    for i, (hl, hl1) in enumerate(zip(halos((xs, z0s, z1s), R), halos((xs, z0s, z1s), R1))):
        c = (xs[i], z0s[i], z1s[i])
        _assert_step_close(tv_pds_megar_shard_step(*c, ext[i], hl, f, a2, i * h - R, **kw),
                           tv_pds_megar_shard_step_plain(*c, ext[i], hl, f, a2, i * h - R, **kw), 2e-6)
        _assert_step_close(tv_pds_mega2_shard_step(*c, ext1[i], hl1, gram, i * h - R1, **kw),
                           tv_pds_mega2_shard_step_plain(*c, ext1[i], hl1, gram, i * h - R1, **kw), 2e-6)
    assert [c.launches - b for c, b in zip(counters, before)] == [P, P, 2 * P]
    torch.cuda.synchronize()


# K16's and K14's tiles are 32 x 64 output pixels staged in shared memory
# (16-byte copies where a row allows, 4-byte ones elsewhere): shard heights
# of 1 (K16), 16, 31, 33 and 45 rows, widths of a multiple of 4 and a tile
# (4096), of neither (4095, 130) and under one tile (50), the first, the
# middle and the last shard, and one shard holding the whole image.
SHARD_TILE_CUTS = (1, 16, 31, 33, 45)


@pytest.mark.parametrize("W", [4096, 4095, 130, 50])
@pytest.mark.parametrize("kernel,K", [("K16", 0), ("K14", 1), ("K14", 5), ("K14", 9), ("K14", 15)])
def test_shard_tiles_match_plain(cuda, rng, W, kernel, K):
    """K16, and K14 at padded reach R = 0, 4, 8 and 15 (identity, 5-, 9-
    and 15-tap rank-1 PSFs), on shards across their tiles' edges against
    their plain versions (the limits of test_shard_kernels_match_plain)."""
    cuts = SHARD_TILE_CUTS if kernel == "K16" else SHARD_TILE_CUTS[1:]
    bounds = np.cumsum((0,) + cuts)
    H = int(bounds[-1])
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x, a = t(np.abs(rng.standard_normal((H, W)))), t(rng.standard_normal((H, W)))
    z0, z1 = t(0.01 * rng.standard_normal((H, W))), t(0.01 * rng.standard_normal((H, W)))
    kw = dict(KW, H_global=H, iso=W != 130, nonneg=W != 130)
    split = lambda v, b: [v[b[j] : b[j + 1]] for j in range(len(b) - 1)]  # noqa: E731
    if kernel == "K16":
        counter, R = tv_pds_sweep_shard_step, 1

        def both(b, hl, j, c):
            args = (*c, hl, int(b[j]) - R)
            return tv_pds_sweep_shard_step(*args, **kw), tv_pds_sweep_shard_step_plain(*args, **kw)

        arrays = (x, a, z0, z1)
    else:
        counter = tv_pds_mega2_shard_step
        gram = Convolve2D((H, W), _rank1_psf(K, K), device=cuda).gram
        R = {1: 1, 5: 5, 9: 9, 15: 16}[K]

        def both(b, hl, j, c):
            ext = halo_extend(split(a, b), R)[j]
            args = (*c, ext, hl, gram, int(b[j]) - R)
            return tv_pds_mega2_shard_step(*args, **kw), tv_pds_mega2_shard_step_plain(*args, **kw)

        arrays = (x, z0, z1)
    before = counter.launches
    for b in (bounds, (0, H)):  # the cut shards, then one shard holding the image
        cores = [split(v, b) for v in arrays]
        for j, hl in enumerate(halos(cores, R)):
            got, want = both(b, hl, j, [c[j] for c in cores])
            _assert_step_close(got, want, 2e-6)
    assert counter.launches - before == len(cuts) + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(48, 50), (256, 384), (100, 130)])
def test_one_shard_mesh_is_the_single_device_kernel(cuda, rng, shape):
    """K14, K15 and K16 on one shard (the whole image, zero halos) equal
    K11, K4 and K3."""
    H, W = shape
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x, atb, g = t(np.abs(rng.standard_normal(shape))), t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    gram = Convolve2D(shape, _rank1_psf(15, 15), device=cuda).gram
    f = Convolve2D(shape, _psf(rng, 2, 15, 15), device=cuda).fwd
    a2 = f.adjoint(2.0)
    zeros = lambda R, n: tuple(torch.zeros((R, W), device=cuda) for _ in range(n))  # noqa: E731
    pad = lambda a, R: torch.cat([a.new_zeros((R, W)), a, a.new_zeros((R, W))])  # noqa: E731
    kw = dict(KW, H_global=H)
    pairs = [
        (tv_pds_mega2_shard_step(x, z0, z1, pad(atb, 16), zeros(16, 6), gram, -16, **kw),
         tv_pds_mega2_step(x, z0, z1, atb, gram, **KW)),
        (tv_pds_megar_shard_step(x, z0, z1, pad(atb, 32), zeros(32, 6), f, a2, -32, **kw),
         tv_pds_megar_step(x, z0, z1, atb, f, a2, **KW)),
        (tv_pds_sweep_shard_step(x, g, z0, z1, zeros(1, 8), -1, **kw), tv_pds_sweep_step_stats(x, z0, z1, g, **KW)),
    ]
    for got, want in pairs:
        _assert_step_close(got, want, 2e-6)


@pytest.mark.parametrize("engine,single", [("megasp", "mega2"), ("megarsp", "megar"), ("sweepsp", "sweepm")])
def test_distributed_on_one_card(cuda, rng, engine, single):
    """DistributedTVDeconv2D on four shards of one card: the engine, its
    kernel four times an iteration (K1 four times for A^H y in conv mode,
    nothing else), and the single-device engine's iterates after 6
    iterations."""
    S, P = (512, 384), 4
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    filt = {"megasp": _gauss(), "megarsp": _psf(rng, 2, 9, 9), "sweepsp": None}[engine]
    mask = torch.from_numpy((rng.random(S) < 0.7).astype(np.float32)).to(cuda) if engine == "sweepsp" else None
    kernel = {"megasp": tv_pds_mega2_shard_step, "megarsp": tv_pds_megar_shard_step,
              "sweepsp": tv_pds_sweep_shard_step}[engine]
    counters = [sepconv2d, tv_pds_mega2_shard_step, tv_pds_megar_shard_step, tv_pds_sweep_shard_step,
                tv_pds_mega2_step, tv_pds_megar_step, tv_pds_sweep_step_stats]
    before = [c.launches for c in counters]
    s = DistributedTVDeconv2D(S, filt, y, 0.05, mesh=make_mesh((P,), devices=[cuda] * P), mask=mask, max_iter=100)
    st = s.run_fixed(6)
    want = {kernel: 6 * P, sepconv2d: 0 if mask is not None else P}
    assert s._sp_engine == engine
    assert [c.launches - b for c, b in zip(counters, before)] == [want.get(c, 0) for c in counters]
    ref = TVDeconvolution(S, y, 0.05, filt=filt, mask=mask, stencil=single, tau=s.tau, sigma=s.sigma,
                          max_iter=100).run_fixed(6)
    out = s.postprocess(st)
    for k in ("x", "z0", "z1"):
        _close(out[k], ref[k], rel=1e-4)
    assert out["x"].device.type == "cuda" and out["x"].shape == S


# -- the 2-D mesh: K17, Spatial2DTVDeconv2D, and K18 ------------------------------


def _grid(a, n0, n1):
    h, w = a.shape[0] // n0, a.shape[1] // n1
    return tuple(tuple(a[i * h : (i + 1) * h, j * w : (j + 1) * w].contiguous() for j in range(n1))
                 for i in range(n0))


@pytest.mark.parametrize("shape,mesh", [((96, 132), (1, 1)), ((96, 132), (2, 2)), ((96, 132), (3, 4)),
                                        ((128, 130), (4, 2)), ((64, 130), (1, 2))])
@pytest.mark.parametrize("rank,K0,K1", [(1, 15, 15), (2, 9, 4), (4, 31, 3)])
def test_block_kernel_matches_plain(cuda, rng, shape, mesh, rank, K0, K1):
    """K17 on every block of an (n0, n1) mesh on one card, halos from the
    exchange, against its plain version; the blocks joined equal K4 on the
    whole image; one launch a block."""
    (H, W), (n0, n1) = shape, mesh
    h, w, R, C = H // n0, W // n1, min(K0, H // n0), HALO_COLS
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    x, atb = t(np.abs(rng.standard_normal(shape))), t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    f = Convolve2D(shape, _psf(rng, rank, K0, K1), device=cuda).fwd
    a2 = f.adjoint(2.0)
    ext = [lane_extend(_grid(v, n0, n1), C) for v in (x, z0, z1)]
    hl, aext = halos_2d(ext, R), halo_extend_2d(_grid(atb, n0, n1), R, C)
    kw = dict(KW, H_global=H, W_global=W)
    before = tv_pds_megar_shard2d_step.launches
    outs = []
    for i in range(n0):
        row = []
        for j in range(n1):
            args = (ext[0][i][j], ext[1][i][j], ext[2][i][j], aext[i][j], hl[i][j], f, a2, (i * h - R, j * w - C))
            got = tv_pds_megar_shard2d_step(*args, **kw)
            _assert_step_close(got, tv_pds_megar_shard2d_step_plain(*args, **kw), 2e-6)
            row.append(got)
        outs.append(row)
    assert tv_pds_megar_shard2d_step.launches - before == n0 * n1
    want = tv_pds_megar_step(x, z0, z1, atb, f, a2, **KW)
    for k in range(3):
        _close(torch.cat([torch.cat([o[k] for o in row], dim=1) for row in outs]), want[k])
    torch.testing.assert_close(sum(o[3] for row in outs for o in row), want[3], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mesh,kernel", [((2, 2), "K17"), ((1, 4), "K17"), ((4, 1), "K15")])
@pytest.mark.parametrize("rank", [1, 2])
def test_spatial2d_on_one_card(cuda, rng, mesh, kernel, rank):
    """Spatial2DTVDeconv2D on a 2-D mesh of four blocks on one card: its
    block kernel four times an iteration (K15 when the columns are not cut),
    K1 four times for A^H y, nothing else; TVDeconvolution[megar]'s iterates
    after 6 iterations."""
    S = (256, 384)
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    filt = _gauss() if rank == 1 else _psf(rng, 2, 9, 9)
    counters = [sepconv2d, tv_pds_megar_shard2d_step, tv_pds_megar_shard_step, tv_pds_megar_step]
    before = [c.launches for c in counters]
    s = Spatial2DTVDeconv2D(S, filt, y, 0.05, mesh=make_mesh(mesh, ("sp0", "sp1"), devices=[cuda] * 4),
                            max_iter=100)
    st = s.run_fixed(6)
    block = tv_pds_megar_shard2d_step if kernel == "K17" else tv_pds_megar_shard_step
    want = {sepconv2d: 4, block: 24}
    assert s._sp_engine == "megar2d"
    assert [c.launches - b for c, b in zip(counters, before)] == [want.get(c, 0) for c in counters]
    ref = TVDeconvolution(S, y, 0.05, filt=filt, stencil="megar", tau=s.tau, sigma=s.sigma,
                          max_iter=100).run_fixed(6)
    out = s.postprocess(st)
    for k in ("x", "z0", "z1"):
        _close(out[k], ref[k], rel=1e-4)
    assert out["x"].device.type == "cuda" and out["x"].shape == S


@pytest.mark.parametrize("shape", [(1, 40), (33, 2), (100, 130), (256, 384)])
@pytest.mark.parametrize("rank,K0,K1", [(1, 15, 15), (1, 8, 6), (2, 7, 7), (2, 9, 4), (4, 31, 3)])
def test_sepgram_apply_matches_plain_and_k2(cuda, rng, shape, rank, K0, K1):
    """K18 against its plain version and against K2 with no atb (the same
    function), odd and even tap counts; one launch a call."""
    h = _psf(rng, rank, K0, K1)
    us, vs = lowrank_factors(h)
    us, vs = tuple(map(tuple, us.T)), tuple(map(tuple, vs.T))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    f = SepFactors(np.asarray(us).T, np.asarray(vs).T, K0 // 2, K1 // 2, cuda)
    before = (sepgram_apply.launches, sepgram2d.launches)
    got = sepgram_apply(x, us, vs)
    assert (sepgram_apply.launches, sepgram2d.launches) == (before[0] + 1, before[1])
    _close(got, sepgram_apply_plain(x, us, vs))
    _close(got, sepgram2d(x, f, f.adjoint()), rel=1e-7)


# -- the shared Gram: every caller at every padded tap count ------------------------

# (Ku, Kv): each of 1, 2, 4, 7, 8, 15, 16 and 31 taps on each axis, Ku != Kv,
# so every padded count (7, 15, 31) runs with the PSF's own taps short of it
GRAM_TAPS = [(1, 2), (2, 4), (4, 7), (7, 8), (8, 15), (15, 16), (16, 31), (31, 1)]


@pytest.mark.parametrize("shape,mesh", [((100, 777), (2, 3)), ((20, 27), (1, 1))])
@pytest.mark.parametrize("Ku,Kv", GRAM_TAPS)
@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_gram_callers_match_plain(cuda, rng, shape, mesh, Ku, Kv, rank):
    """Every kernel on the shared Gram (sepconv.cuh: K1, K2, K4, K7, K8, K9,
    K15, K17, K18) against its plain version for random rank-``rank``
    factors of Ku x Kv taps, on an image whose sides are not multiples of 32
    and on one smaller than a tile; K15 on one shard and K17 on one block are
    K4 bit for bit, K18 is K2."""
    u, v = rng.standard_normal((Ku, rank)), rng.standard_normal((Kv, rank))
    u, v = u / np.abs(u).sum(0), v / np.abs(v).sum(0)
    f = SepFactors(u, v, Ku // 2, Kv // 2, cuda)
    a, a2 = f.adjoint(), f.adjoint(2.0)
    t = lambda arr: torch.from_numpy(arr.astype(np.float32)).to(cuda)  # noqa: E731
    (H, W), (n0, n1) = shape, mesh
    x, atb, xi = t(np.abs(rng.standard_normal(shape))), t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    z0, z1 = t(0.01 * rng.standard_normal(shape)), t(0.01 * rng.standard_normal(shape))
    m = t(rng.random(shape) < 0.7)
    _close(sepconv2d(x, f), sepconv2d_plain(x, f))
    _close(sepconv2d(x, a), sepconv2d_plain(x, a))
    gram = sepgram2d(x, f, a)
    _close(gram, sepgram2d_plain(x, f, a))
    _close(sepgram2d(x, f, a2, atb), sepgram2d_plain(x, f, a2, atb))
    us, vs = tuple(map(tuple, u.T)), tuple(map(tuple, v.T))
    assert torch.equal(sepgram_apply(x, us, vs), gram)
    k4 = tv_pds_megar_step(x, z0, z1, atb, f, a2, **KW)
    _assert_step_close(k4, tv_pds_megar_step_plain(x, z0, z1, atb, f, a2, **KW), 2e-6)
    _assert_step_close(tv_pds_megarm_step(x, z0, z1, m, atb, f, a2, **KW),
                       tv_pds_megarm_step_plain(x, z0, z1, m, atb, f, a2, **KW), 2e-6)
    mom = torch.tensor([0.3], device=cuda)
    got = lasso_fista_step(x, z0, atb, mom, f, a2, tau=0.5, lam=0.01)
    want = lasso_fista_step_plain(x, z0, atb, mom.reshape(()), f, a2, tau=0.5, lam=0.01)
    for i in range(2):
        _close(got[i], want[i])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-7)
    si, wf = torch.tensor([3, 25], dtype=torch.int32, device=cuda), torch.tensor([1.0], device=cuda)
    pk = dict(gamma=1 / 3, tau=1.0, lam=0.01, prox_mode="l1", noise_mode="stream", noise=xi)
    for g, w in zip(pmyula_mega_step(x, atb, z0, z1, si, wf, f, a2, **pk),
                    pmyula_mega_step_plain(x, atb, z0, z1, si, wf, f, a2, **pk)):
        _close(g, w)
    # K15 on n0 row shards and on one, K17 on the n0 x n1 blocks and on one
    # (a mesh of one: the image is shorter than the 32 halo rows)
    R, C = 32, HALO_COLS
    h, w = H // n0, W // n1
    kw = dict(KW, H_global=H)
    xs, as_, z0s, z1s = ([v[i * h : (i + 1) * h] for i in range(n0)] for v in (x, atb, z0, z1))
    for i, (hl, ext) in enumerate(zip(halos((xs, z0s, z1s), R), halo_extend(as_, R)) if n0 > 1 else ()):
        c = (xs[i], z0s[i], z1s[i])
        _assert_step_close(tv_pds_megar_shard_step(*c, ext, hl, f, a2, i * h - R, **kw),
                           tv_pds_megar_shard_step_plain(*c, ext, hl, f, a2, i * h - R, **kw), 2e-6)
    pad = lambda b: torch.cat([b.new_zeros((R, W)), b, b.new_zeros((R, W))])  # noqa: E731
    zr = tuple(torch.zeros((R, W), device=cuda) for _ in range(6))
    for g, w_ in zip(tv_pds_megar_shard_step(x, z0, z1, pad(atb), zr, f, a2, -R, **kw), k4):
        assert torch.equal(g, w_)
    kw2 = dict(KW, H_global=H, W_global=W)
    if n0 > 1:
        ext = [lane_extend(_grid(v, n0, n1), C) for v in (x, z0, z1)]
        hl, aext = halos_2d(ext, R), halo_extend_2d(_grid(atb, n0, n1), R, C)
    for i in range(n0 if n0 > 1 else 0):
        for j in range(n1):
            args = (ext[0][i][j], ext[1][i][j], ext[2][i][j], aext[i][j], hl[i][j], f, a2, (i * h - R, j * w - C))
            _assert_step_close(tv_pds_megar_shard2d_step(*args, **kw2),
                               tv_pds_megar_shard2d_step_plain(*args, **kw2), 2e-6)
    cpad = lambda b: torch.cat([b.new_zeros((b.shape[0], C)), b, b.new_zeros((b.shape[0], C))], 1)  # noqa: E731
    ae = torch.cat([atb.new_zeros((R, W + 2 * C)), cpad(atb), atb.new_zeros((R, W + 2 * C))])
    zr = tuple(torch.zeros((R, W + 2 * C), device=cuda) for _ in range(6))
    for g, w_ in zip(tv_pds_megar_shard2d_step(cpad(x), cpad(z0), cpad(z1), ae, zr, f, a2, (-R, -C), **kw2), k4):
        assert torch.equal(g, w_)
    torch.cuda.synchronize()


# -- Convolve2D's other methods and the FFT Gram (ops/_gram.py) on the card -----


def _rank_psf(seed, rank, K):
    r = np.random.default_rng(seed)
    h = (r.standard_normal((K, rank)) @ r.standard_normal((K, rank)).T).astype(np.float32)
    return h / np.abs(h).sum()


def _abs_psf(seed, K):
    h = np.abs(np.random.default_rng(seed).standard_normal((K, K))).astype(np.float32)
    return h / h.sum()


@pytest.mark.parametrize("shape", [(4096, 4096), (333, 517)])
@pytest.mark.parametrize("rank", [6, 12])
def test_bandg_groups_match_plain(cuda, rng, shape, rank):
    """"auto" on the card takes 'bandg' for a rank 5-16 PSF within 31 taps:
    K1 once per group of at most 4 factors, forward and adjoint, against
    the sum of K1's plain versions over the groups (2e-6 of the largest
    magnitude)."""
    h = _rank_psf(rank, rank, 15)
    A = Convolve2D(shape, h, device=cuda)
    assert A.method == "bandg" and len(A.groups) == -(-rank // 4)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    n0 = sepconv2d.launches
    got_f, got_a = A.apply(x), A.adjoint(x)
    assert sepconv2d.launches == n0 + 2 * len(A.groups)
    _close(got_f, sum(sepconv2d_plain(x, f) for f, _ in A.groups))
    _close(got_a, sum(sepconv2d_plain(x, a) for _, a in A.groups))
    torch.cuda.synchronize()


def test_auto_method_on_the_card(cuda):
    """On the card: band for rank <= 4, bandg for rank 5-16 within 31 taps
    (bench.py's 15 x 15 full-rank PSF has rank 15; a 5 x 5 full-rank one,
    'direct' on the CPU, rank 5), 'fft' for rank 17 or over 31 taps, with
    the FFT Gram."""
    S = (256, 384)
    assert Convolve2D(S, _rank_psf(0, 2, 9), device=cuda).method == "band"
    assert Convolve2D(S, _rank_psf(0, 6, 15), device=cuda).method == "bandg"
    assert Convolve2D(S, _abs_psf(7, 15), device=cuda).method == "bandg"  # rank 15
    A = Convolve2D(S, _abs_psf(7, 17), device=cuda)
    assert A.method == "fft" and type(A.gram).__name__ == "ConvGram2D"
    assert Convolve2D(S, _rank_psf(0, 6, 33), device=cuda).method == "fft"
    assert Convolve2D(S, _abs_psf(3, 5), device=cuda).method == "bandg"  # rank 5


@pytest.mark.parametrize("flavour", ["conv", "combined", "lasso"])
@pytest.mark.parametrize("psf", ["gauss15", "rank2", "rank6", "abs17"])
def test_solvers_take_the_users_convolution_on_the_card(cuda, rng, monkeypatch, psf, flavour):
    """``PDS`` (TV, and TV with a keep mask after the convolution) and
    ``APGD`` (LASSO) of ``SquaredL2Loss(y) * A`` on the card take the user's
    ``A`` as it is, computing no FFT bound, and give the engine the solver
    builds from ``A``'s taps (the parent's route): the same engine, ``beta``
    and ``A^H y``, and the same iterates bit for bit after 40 iterations.
    The PSFs take mega3, megar, sweep over 'bandg' and sweep over the FFT
    Gram in conv mode."""
    from pycsou_tpu_torch.ops import conv as conv_mod
    from pycsou_tpu_torch.opt import LassoDeconvolution
    from pycsou_tpu_torch.opt.fuse import _back_projection

    S = (512, 768)
    h = {"gauss15": _gauss(), "rank2": _rank_psf(0, 2, 9), "rank6": _rank_psf(0, 6, 15),
         "abs17": _abs_psf(7, 17)}[psf]
    A = Convolve2D(S, h, device=cuda)
    y = A(torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda))
    calls = []
    real = conv_mod._fft_lipschitz
    monkeypatch.setattr(conv_mod, "_fft_lipschitz", lambda *a: calls.append(a) or real(*a))
    tv = dict(G=NonNegativeOrthant(S), H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S))
    if flavour == "conv":
        p = PDS(S, F=SquaredL2Loss(S, data=y) * A, **tv)
    elif flavour == "combined":
        M = Masking(S, torch.from_numpy(rng.random(S) < 0.7).to(cuda))
        p = PDS(S, F=SquaredL2Loss(M.codim_shape, data=M(y)) * (M * A), **tv)
    else:
        p = APGD(S, F=SquaredL2Loss(S, data=y) * A, G=0.01 * L1Norm(S))
    assert calls == [] and p._fused.filt is A.filt
    if flavour == "lasso":
        ref = LassoDeconvolution(S, y, 0.01, filt=A.filt, tau=p.tau, acceleration=p.acceleration, d=p.d)
        assert p._fused.engine == ref.engine
        keys = ("x", "x_temp")
    else:
        mask, y_img = _back_projection(M, M(y)) if flavour == "combined" else (None, y)
        ref = TVDeconvolution(S, y_img, 0.05, filt=A.filt, mask=mask, nonneg=True, tau=p.tau, sigma=p.sigma,
                              rho=p.rho)
        assert p._fused.stencil_mode == ref.stencil_mode
        keys = ("x", "z0", "z1")
    assert len(calls) == 1  # the reference's build from the taps
    assert p._fused.beta == ref.beta and torch.equal(p._fused.atb, ref.atb)
    got, want = p._fused.run_fixed(40), ref.run_fixed(40)
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape,K,wrap", [((512, 384), 15, True), ((512, 384), 15, False),
                                         ((333, 517), 17, False), ((256, 256), 9, True)])
def test_conv_gram_on_the_card(cuda, rng, shape, K, wrap):
    """ConvGram2D on the card (cuFFT, the transfers cached on the card)
    against its CPU result and against adjoint(apply(x)) of the 'fft'
    convolution, within 1e-5 of the largest magnitude; 'direct' on the card
    (cuDNN at full f32) against the CPU within 2e-6."""
    h = _abs_psf(K, K)
    x = rng.standard_normal(shape).astype(np.float32)
    A = Convolve2D(shape, h, method="fft", device=cuda)
    G = ConvGram2D(A, wrap=wrap)
    assert all(v.device.type == "cuda" for v in [G.h2_hat, *G.cache.values()])
    xc = torch.from_numpy(x).to(cuda)
    got = G.apply(xc)
    Gc = ConvGram2D(Convolve2D(shape, h, method="fft", device="cpu"), wrap=wrap)
    _close(got.cpu(), Gc.apply(torch.from_numpy(x)), rel=1e-5)
    _close(got, A.adjoint(A.apply(xc)), rel=1e-5)
    D = Convolve2D(shape, h, method="direct", device=cuda)
    Dc = Convolve2D(shape, h, method="direct", device="cpu")
    _close(D.apply(xc).cpu(), Dc.apply(torch.from_numpy(x)))
    _close(D.adjoint(xc).cpu(), Dc.adjoint(torch.from_numpy(x)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("psf", ["rank6", "fullrank"])
def test_other_psf_sweep_engines_on_the_card(cuda, rng, psf):
    """The rank-6 PSF on 'bandg' + sweep (K1 4 and K3 once an iteration,
    through PDS fusion) and the full-rank PSF on the FFT Gram + sweep (K3
    once, no K1), each held after 5 iterations to the same solver on the
    other's Gram route (the 'fft' Gram, the padded Gram) within 1e-4 of
    max(1, max |x|)."""
    S = (256, 384)
    h = _rank_psf(11, 6, 15) if psf == "rank6" else _abs_psf(7, 17)
    y = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(cuda)
    p = PDS(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, h, device=cuda), G=NonNegativeOrthant(S),
            H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=100)
    tv = p._fused
    assert tv.stencil_mode == "sweep"
    n1, n3 = sepconv2d.launches, tv_pds_sweep_step_stats.launches
    st = p.run_fixed(5)
    assert tv_pds_sweep_step_stats.launches == n3 + 5
    assert sepconv2d.launches == n1 + (20 if psf == "rank6" else 0)
    alt = TVDeconvolution(S, y, 0.05, filt=h, max_iter=100)
    if psf == "rank6":
        assert type(alt.gram).__name__ == "SymmetricLinearOperator"
        alt.gram = Convolve2D(S, h, method="fft", device=cuda).gram
    else:
        assert type(alt.gram) is ConvGram2D and alt.gram.wrap  # 256 and 384 are fast FFT sizes
        alt.gram = ConvGram2D(Convolve2D(S, h, device=cuda), wrap=False)
    ot = alt.run_fixed(5)
    scale = max(1.0, float(st["x"].abs().max()))
    for k in ("x", "z0", "z1"):
        assert float((ot[k] - st[k]).abs().max()) <= 1e-4 * scale, k
    torch.cuda.synchronize()


def test_combined_fullrank_on_the_card(cuda, rng):
    """Blurred super-resolution with a full-rank PSF runs sweep (K3 once an
    iteration, the gradient through the FFT convolution) and agrees with
    the plain K3 steps on the same gradient after 5 iterations."""
    S = (128, 192)
    h = _abs_psf(7, 17)
    keep = np.random.default_rng(13).random(S) < 0.7
    M = Masking(S, keep, device=cuda)
    A = M * Convolve2D(S, h, device=cuda)
    y = A(torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda))
    p = PDS(S, F=SquaredL2Loss(A.codim_shape, data=y) * A, G=NonNegativeOrthant(S),
            H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=100)
    tv = p._fused
    assert (tv.mode, tv.stencil_mode) == ("combined", "sweep")
    n3 = tv_pds_sweep_step_stats.launches
    st = p.run_fixed(5)
    assert tv_pds_sweep_step_stats.launches == n3 + 5
    x, z0, z1 = (torch.zeros(S, device=cuda) for _ in range(3))
    kw = dict(tau=tv.tau, sigma=tv.sigma, rho=tv.rho, lam=tv.lam, nonneg=tv.nonneg, iso=tv.iso)
    for _ in range(5):
        x, z0, z1, _ = tv_pds_sweep_step_stats_plain(x, z0, z1, tv._grad(x), **kw)
    for k, want in (("x", x), ("z0", z0), ("z1", z1)):
        _close(st[k], want, rel=1e-5)


# -- the stacked operators and spectral estimates ---------------------------


def _new_operators(device, S=(48, 40)):
    """The new operators (derivatives, stacks, Kronecker, transforms,
    structural) from one set of numpy inputs on ``device``."""
    import scipy.sparse as sp

    from pycsou_tpu_torch import ops

    rng = np.random.default_rng(31)
    n = S[0] * S[1]
    field = rng.standard_normal((2,) + S).astype(np.float32)
    d = rng.standard_normal(S).astype(np.float32)
    fa = rng.standard_normal((S[0], S[0])).astype(np.float32)
    fb = rng.standard_normal((S[1], S[1])).astype(np.float32)
    kb = rng.standard_normal((S[1], 9)).astype(np.float32)
    band = sp.diags([rng.standard_normal(n - 1), rng.standard_normal(n)], [1, 0], shape=(n, n), format="csr",
                    dtype=np.float32)
    dev = dict(device=device)
    D, dct = ops.DiagonalOperator(d, **dev), ops.DCTOperator(S, **dev)
    return {
        "first backward": ops.FirstDerivative(S, axis=1, kind="backward"),
        "first centered": ops.FirstDerivative(S, kind="centered"),
        "second": ops.SecondDerivative(S),
        "sobolev": ops.GeneralisedDerivative(S, kind="sobolev", order=2, **dev),
        "gradient centered": ops.Gradient(S, kind="centered"),
        "generalised laplacian": ops.GeneralisedLaplacian(S, kind="polynomial", coeffs=[1.0, 0.5], **dev),
        "directional": ops.DirectionalGradient(S, [np.array([0.0, 1.0]), field], **dev),
        "directional laplacian": ops.DirectionalLaplacian(S, [field], **dev),
        "integration": ops.Integration1D(S),
        "vstack": ops.LinOpVStack([ops.Masking(S, d > 0, **dev), dct]),
        "hstack": ops.LinOpHStack([dct, D]),
        "block": ops.BlockOperator([[dct, D], [D, ops.IDCTOperator(S, **dev)]]),
        "blockdiag": ops.BlockDiagonalOperator([D, dct]),
        "kron": ops.KroneckerProduct(ops.DenseOperator(fa, **dev), ops.DenseOperator(fb, **dev)),
        "kronsum": ops.KroneckerSum(ops.DenseOperator(fa, **dev), ops.DiagonalOperator(fb[0], **dev)),
        "khatri-rao": ops.KhatriRaoProduct(fa[:, :9], kb, **dev),
        "fft": ops.FFTOperator(S),
        "sparse": ops.SparseOperator(band, dim_shape=S, codim_shape=S, **dev),
        "polynomial": ops.PolynomialOperator(D, [1.0, -2.0, 0.5]),
    }


def test_new_operators_on_the_card(cuda):
    """Each new operator on the card against the port's CPU (2e-6 relative
    to the largest magnitude; 1e-5 for the products summed by cuBLAS and
    cuFFT), and the adjoint identity on the card."""
    card, cpu = _new_operators(cuda), _new_operators("cpu")
    rng = np.random.default_rng(32)
    for name, op in card.items():
        def draw(shape):
            v = rng.standard_normal(shape).astype(np.float32)
            if op.dtype.is_complex:
                v = (v + 1j * rng.standard_normal(shape)).astype(np.complex64)
            return torch.from_numpy(v)

        x, y = draw(op.dim_shape), draw(op.codim_shape)
        ax, ahy = op.apply(x.to(cuda)), op.adjoint(y.to(cuda))
        assert ax.device.type == ahy.device.type == cuda.type, name
        for got, want in ((ax, cpu[name].apply(x)), (ahy, cpu[name].adjoint(y))):
            scale = max(1.0, float(want.abs().max()))
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale, name
        lhs = torch.vdot(y.to(cuda).reshape(-1), ax.reshape(-1))
        rhs = torch.vdot(ahy.reshape(-1), x.to(cuda).reshape(-1))
        assert float((lhs - rhs).abs()) <= 1e-4 * float(ax.norm() * y.norm()), name


def test_spectral_estimates_on_the_card(cuda, monkeypatch):
    """The power iteration and CG read ``done`` every 16 iterations or
    before every one: the same result, the same counted applies; the
    estimates and the start vector equal the CPU's."""
    from pycsou_tpu_torch.ops import DenseOperator, DiagonalOperator
    from pycsou_tpu_torch.utils import opnorm

    rng = np.random.default_rng(33)
    d = np.concatenate([[5.0, 0.3], rng.uniform(1.0, 2.0, 4094)]).astype(np.float32).reshape(64, 64)
    D = DiagonalOperator(d, device=cuda)
    assert torch.equal(opnorm._rand_like(0, (64, 64), torch.float32, cuda).cpu(),
                       opnorm._rand_like(0, (64, 64), torch.float32, "cpu"))
    x0 = opnorm._rand_like(0, D.dim_shape, D.dtype, cuda)
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).to(cuda)
    runs = {}
    for every in (1, 16):
        monkeypatch.setattr(opnorm, "_SYNC_EVERY", every)
        runs[every] = [opnorm._power_iter(D, x0, maxiter, tol) for maxiter, tol in ((128, 1e-6), (40, 0.0))]
        runs[every].append(opnorm.cg(D.apply, b, tol=1e-6))
    for (v1, n1), (v16, n16) in zip(runs[1][:2], runs[16][:2]):
        assert float(v1) == float(v16) and int(n1) == int(n16)
    x1, x16 = runs[1][2], runs[16][2]
    assert torch.equal(x1, x16)
    assert float((D.apply(x16) - b).norm()) <= 1.01e-6 * float(b.norm())
    D_cpu = DiagonalOperator(d, device="cpu")
    assert D.opnorm() == pytest.approx(D_cpu.opnorm(), rel=1e-6)
    assert opnorm.smallest_eig_psd(D.gram, maxiter=32) == pytest.approx(0.09, rel=1e-3)
    a = rng.standard_normal((80, 60)).astype(np.float32)
    A, A_cpu = DenseOperator(a, device=cuda), DenseOperator(a, device="cpu")
    assert A.opnorm(exact=False) == pytest.approx(A_cpu.opnorm(exact=False), rel=1e-5)
    assert A.opnorm() == pytest.approx(float(np.linalg.norm(a.astype(np.float64), 2)), rel=1e-5)
    y = torch.from_numpy(rng.standard_normal(80).astype(np.float32))
    torch.testing.assert_close(A.pinv(y.to(cuda)).cpu(), A_cpu.pinv(y), rtol=1e-4, atol=1e-4)


def test_dense_opnorm_near_the_exact_limit(cuda):
    """DenseOperator's exact norm at 2000 x 2000 (4e6 entries, the most it
    takes exactly) of a matrix built from singular values 6.0, 0.4 and the
    rest in [1, 3]: 6.0 to 1e-5 relative."""
    from pycsou_tpu_torch.ops import DenseOperator

    n = 2000
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=cuda, dtype=torch.float64))
    V, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=cuda, dtype=torch.float64))
    sv = torch.cat([torch.tensor([6.0, 0.4], device=cuda, dtype=torch.float64),
                    1.0 + 2.0 * torch.rand(n - 2, generator=g, device=cuda, dtype=torch.float64)])
    A = DenseOperator(((U * sv) @ V.T).to(torch.float32))
    assert A.dim * A.codim == 4_000_000
    assert A.opnorm() == pytest.approx(6.0, rel=1e-5)


def test_todense_and_batched_pinv_on_the_card(cuda, monkeypatch):
    """todense on the card equals the CPU's, each operator the vmapped
    batches of its basis; a band Convolve2D (K1, not batchable) maps one
    column a launch.  The Kronecker product's pinv (one batched CG a
    factor) equals the CPU's and ``pinv(fa) kron pinv(fb)``, the same x
    whether the CG reads the host every 16 iterations or every one."""
    from pycsou_tpu_torch import ops, set_default_device
    from pycsou_tpu_torch.utils import opnorm

    card = _new_operators(cuda)
    set_default_device("cpu")  # the operators that hold no tensor take the default device
    try:
        cpu = {name: op.todense().mat for name, op in _new_operators("cpu").items()}
    finally:
        set_default_device(None)
    for name, op in card.items():
        got, want = op.todense().mat, cpu[name]
        assert got.device.type == cuda.type and want.device.type == "cpu", name
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max())), name
    rng = np.random.default_rng(34)
    S = (24, 20)
    h = np.outer(rng.random(5), rng.random(5)).astype(np.float32)
    C, C_cpu = ops.Convolve2D(S, h, device=cuda), ops.Convolve2D(S, h, device="cpu")
    assert not C.batchable and C.method == "band"
    sepconv2d.launches = 0
    dense = C.todense().mat
    assert sepconv2d.launches == C.dim
    torch.testing.assert_close(dense.cpu(), C_cpu.todense().mat, rtol=1e-5, atol=1e-6)
    fa = rng.standard_normal((12, 9)).astype(np.float32)
    fb = rng.standard_normal((10, 7)).astype(np.float32)
    K = ops.KroneckerProduct(ops.DenseOperator(fa, device=cuda), ops.DenseOperator(fb, device=cuda))
    K_cpu = ops.KroneckerProduct(ops.DenseOperator(fa, device="cpu"), ops.DenseOperator(fb, device="cpu"))
    y = torch.from_numpy(rng.standard_normal((12, 10)).astype(np.float32))
    runs = {}
    for every in (1, 16):
        monkeypatch.setattr(opnorm, "_SYNC_EVERY", every)
        runs[every] = K.pinv(y.to(cuda), tol=1e-6)
    assert torch.equal(runs[1], runs[16])
    want = np.kron(np.linalg.pinv(fa), np.linalg.pinv(fb)) @ y.numpy().ravel()
    np.testing.assert_allclose(runs[16].cpu().numpy().ravel(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(runs[16].cpu(), K_cpu.pinv(y, tol=1e-6), rtol=1e-4, atol=1e-4)


def test_cfg4_on_the_card(cuda):
    """bench.py's cfg4 at 64 x 64 on the card: ||A|| = sqrt(2) and the
    CPU's, 6 APGD iterations against the port's CPU run; no kernel of the
    port runs."""
    from pycsou_tpu_torch.ops import DCTOperator, LinOpVStack, Masking

    def build(device):
        rng = np.random.default_rng(4)
        mask = rng.random((64, 64)) < 0.3
        A = LinOpVStack([Masking((64, 64), mask, device=device), DCTOperator((64, 64), device=device)])
        A.compute_lipschitz_cst(maxiter=30)
        x_true = np.zeros((64, 64), np.float32)
        x_true[rng.choice(64, 40), rng.choice(64, 40)] = 3.0
        y = A(torch.from_numpy(x_true).to(device))
        return A, APGD((64, 64), F=SquaredL2Loss(A.codim_shape, data=y) * A, G=0.02 * L1Norm((64, 64)))

    A, s = build(cuda)
    A_cpu, s_cpu = build("cpu")
    assert A.lipschitz == pytest.approx(np.sqrt(2.0), abs=1e-5)
    assert A.lipschitz == pytest.approx(A_cpu.lipschitz, rel=1e-6)
    st, st_cpu = s.run_fixed(6), s_cpu.run_fixed(6)
    for k in ("x", "x_temp"):
        _close(st[k].cpu(), st_cpu[k], rel=1e-5)


def test_unknown_norm_pds_on_the_card(cuda):
    """A PDS with an unknown ||K||: the power iteration launches K1 twice a
    Gram apply and gives the CPU's estimate."""
    from pycsou_tpu_torch.utils import opnorm

    S = (96, 128)
    h = _psf(np.random.default_rng(34), 1, 15, 15)
    y = np.random.default_rng(35).standard_normal(S).astype(np.float32)

    def build(device):
        K = Convolve2D(S, np.abs(h) / np.abs(h).sum(), device=device).replace(_lipschitz=float("inf"))
        return PDS(S, F=SquaredL2Loss(S, data=torch.from_numpy(y).to(device)), H=L1Norm(S), K=K)

    before, applies = sepconv2d.launches, opnorm.power_iteration.applies
    p = build(cuda)
    torch.cuda.synchronize()
    assert sepconv2d.launches - before == 2 * (opnorm.power_iteration.applies - applies)
    assert p.K.lipschitz == pytest.approx(build("cpu").K.lipschitz, rel=1e-5)
    assert p.K.lipschitz <= 1 + 1e-5


def _conv_nd_operators(device):
    """The 1-D, N-D and circular convolutions (and their Grams) at small
    shapes on ``device``."""
    from pycsou_tpu_torch import ops

    rng = np.random.default_rng(41)
    dev = dict(device=device)
    h1, h3 = rng.standard_normal(5).astype(np.float32), rng.standard_normal((3, 2, 3)).astype(np.float32)
    u = [rng.standard_normal(k) for k in (3, 1, 4)]
    sep = np.multiply.outer(np.multiply.outer(u[0], u[1]), u[2]).astype(np.float32)
    out = {f"conv1d {m}": ops.Convolve1D((1000,), h1, method=m, **dev) for m in ("direct", "fft", "overlap-add")}
    out.update({
        "moving average 1d": ops.MovingAverage1D((300,), 4, **dev),
        "convnd": ops.ConvolveND((9, 10, 11), h3, **dev),
        "convnd rank 1": ops.ConvolveND((9, 10, 12), sep, **dev),
        "circular": ops.CircularConvolve((8, 9), rng.standard_normal((3, 4)).astype(np.float32), **dev),
    })
    out.update({f"{k} gram": op.gram for k, op in list(out.items())})
    return out


def test_conv_nd_operators_on_the_card(cuda):
    """The 1-D, N-D and circular convolutions and their Grams on the card
    against the port's CPU (1e-5 relative to the largest magnitude: cuFFT
    and cuDNN against the CPU's FFT and convolution), the Gram types equal,
    and the adjoint identity on the card."""
    card, cpu = _conv_nd_operators(cuda), _conv_nd_operators("cpu")
    rng = np.random.default_rng(42)
    for name, op in card.items():
        assert type(op).__name__ == type(cpu[name]).__name__, name
        x = torch.from_numpy(rng.standard_normal(op.dim_shape).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal(op.codim_shape).astype(np.float32))
        ax, ahy = op.apply(x.to(cuda)), op.adjoint(y.to(cuda))
        for got, want in ((ax, cpu[name].apply(x)), (ahy, cpu[name].adjoint(y))):
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max())), name
        lhs = torch.vdot(y.to(cuda).reshape(-1), ax.reshape(-1))
        rhs = torch.vdot(ahy.reshape(-1), x.to(cuda).reshape(-1))
        assert float((lhs - rhs).abs()) <= 1e-4 * float(ax.norm() * y.norm()), name


def test_moving_average2d_launches_k1(cuda, rng):
    """MovingAverage2D is a band Convolve2D: one K1 launch an apply and one
    an adjoint, each equal to K1's plain version."""
    from pycsou_tpu_torch.ops import MovingAverage2D

    M = MovingAverage2D((300, 517), (5, 5), device=cuda)
    assert M.method == "band" and not M.batchable
    x = torch.from_numpy(rng.standard_normal((300, 517)).astype(np.float32)).to(cuda)
    before = sepconv2d.launches
    y, z = M.apply(x), M.adjoint(x)
    assert sepconv2d.launches == before + 2
    _close(y, sepconv2d_plain(x, M.fwd))
    _close(z, sepconv2d_plain(x, M.adj))


def test_consensus_admm_default_mesh_on_one_card(cuda):
    """``ConsensusADMM(mesh=None)`` takes every visible card once; on one
    card one block.  Fourier backend against the CPU mesh after 20
    iterations (1e-5 x max |z|); CG backend on band Convolve2Ds: K1 one a
    scenario a step for ``A^H y`` and two a row for each counted CG apply."""
    from pycsou_tpu_torch.opt import ConsensusADMM
    from pycsou_tpu_torch.opt.admm import stack_operators
    from pycsou_tpu_torch.utils.opnorm import cg

    rng = np.random.default_rng(5)
    d, S = 16, 4
    x_true = np.abs(rng.standard_normal((d, d, d))).astype(np.float32)
    h_hats, data = [], []
    for _ in range(S):
        psf = np.zeros((d, d, d), np.float32)
        psf[:3, :3, :3] = rng.random((3, 3, 3)).astype(np.float32)
        H = np.fft.rfftn(psf / psf.sum())
        h_hats.append(H)
        data.append(np.fft.irfftn(np.fft.rfftn(x_true) * H, s=(d, d, d), axes=(0, 1, 2)).astype(np.float32))
    h_hats, data = np.stack(h_hats), np.stack(data)
    admm = ConsensusADMM((d, d, d), h_hats=h_hats, data=data, g=NonNegativeOrthant((d, d, d)))
    assert admm.mesh.size == torch.cuda.device_count() and admm.mesh.devices[0].type == "cuda"
    z = admm.run(20)
    cpu = ConsensusADMM((d, d, d), h_hats=h_hats, data=data, g=NonNegativeOrthant((d, d, d)),
                        mesh=make_mesh((1,), ("dp",), devices=["cpu"])).run(20)
    assert float((z.cpu() - cpu).abs().max()) <= 1e-5 * max(1.0, float(cpu.abs().max()))

    n = 64
    ops = [Convolve2D((n, n), _psf(rng, 1, 7, 7), device=cuda) for _ in range(S)]
    xt = torch.from_numpy(np.abs(rng.standard_normal((n, n))).astype(np.float32)).to(cuda)
    ys = torch.stack([op.apply(xt) for op in ops])
    admm = ConsensusADMM((n, n), ops=stack_operators(ops), data=ys, g=NonNegativeOrthant((n, n)),
                         mesh=make_mesh((1,), ("dp",), devices=[cuda]), cg_maxiter=20)
    k1, applies = sepconv2d.launches, cg.applies
    admm.run(3)
    assert sepconv2d.launches - k1 == S * 3 + 2 * S * (cg.applies - applies)


# -- the proximal calculus and the sampling operators on the card


def _prox_cases(shape, groups):
    """``(name, make)``: ``make(x, xpos, z)`` builds the functional on the
    inputs' device and returns the call of a new prox, projection or apply."""
    from pycsou_tpu_torch import func as f
    from pycsou_tpu_torch.math.prox import lambertw, proj_l1_ball, proj_l2_ball, proj_segment, sign

    n = int(np.prod(shape))

    def stack(x, p, z):
        F = f.ProxFuncHStack([f.KLDivergence(shape, p), f.L21Norm(shape)])
        xx = torch.cat([x.reshape(-1), x.reshape(-1)])
        return lambda: F.prox(xx, 0.3)

    def groups_mode(x, p, z):
        F = f.L21Norm(shape, groups=groups, device=x.device)
        return lambda: torch.cat([F.prox(x, 0.5).reshape(-1), F.apply(x).reshape(1)])

    def kl(x, p, z):
        F = f.KLDivergence(shape, torch.flip(p, (0,)))
        return lambda: torch.cat([F.prox(x, 0.4).reshape(-1), F.apply(p).reshape(1)])

    return [
        ("proj_l1_ball", lambda x, p, z: lambda: proj_l1_ball(x, 0.05 * n)),
        ("proj_l2_ball", lambda x, p, z: lambda: proj_l2_ball(z, 3.0)),
        ("proj_segment", lambda x, p, z: lambda: proj_segment(z, -0.2, 0.4)),
        ("sign", lambda x, p, z: lambda: sign(z)),
        ("SquaredL1Norm sort", lambda x, p, z: lambda: f.SquaredL1Norm(shape, "sort").prox(x, 1e-4)),
        ("SquaredL1Norm root", lambda x, p, z: lambda: f.SquaredL1Norm(shape, "root").prox(x, 1e-4)),
        ("L2Norm", lambda x, p, z: lambda: f.L2Norm(shape).prox(x, 50.0)),
        ("L2Ball", lambda x, p, z: lambda: f.L2Ball(shape, 10.0).prox(x, 1.0)),
        ("LInftyNorm", lambda x, p, z: lambda: f.LInftyNorm(shape).prox(x, 0.05 * n)),
        ("LInftyBall", lambda x, p, z: lambda: f.LInftyBall(shape, 1.0).prox(z, 1.0)),
        ("Segment", lambda x, p, z: lambda: f.Segment(shape, -0.5, 0.5).prox(x, 1.0)),
        ("LogBarrier", lambda x, p, z: lambda: torch.cat([f.LogBarrier(shape).prox(x, 0.3).reshape(-1),
                                                          f.LogBarrier(shape).apply(p).reshape(1)])),
        ("ShannonEntropy", lambda x, p, z: lambda: f.ShannonEntropy(shape).prox(p, 0.7)),
        ("KLDivergence", kl),
        ("L21Norm groups", groups_mode),
        ("L21Norm axis complex", lambda x, p, z: lambda: f.L21Norm(shape, axis=0).prox(z, 0.5)),
        ("lambertw", lambda x, p, z: lambda: lambertw(20.0 * p)),
        ("L1Norm complex", lambda x, p, z: lambda: f.L1Norm(shape).prox(z, 0.5)),
        ("SquaredL2Norm complex", lambda x, p, z: lambda: f.SquaredL2Norm(shape).apply(z)),
        ("ShannonEntropy apply", lambda x, p, z: lambda: f.ShannonEntropy(shape).apply(p)),
        ("KL and L21 stack", stack),
    ]


@pytest.mark.parametrize("case", range(21))
def test_prox_on_the_card_matches_cpu_without_a_sync(cuda, rng, case):
    """Each new prox, projection and apply on CUDA tensors at 96 x 130,
    built outside the check: within 1e-4 of the CPU (the sort-based
    thresholds and fixed loops), and no host read
    (``set_sync_debug_mode('error')``) once warm."""
    shape = (96, 130)
    groups = (np.arange(96)[:, None] // 8) * 17 + np.arange(130)[None, :] // 8
    name, make = _prox_cases(shape, groups)[case]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p = x.abs() + 1.0
    z = torch.complex(x, torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    want = make(x, p, z)()
    call = make(*[v.to(cuda) for v in (x, p, z)])
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device.type == "cuda", name
    _close(got.cpu(), want, rel=1e-4)


def test_sampling_operators_on_the_card_match_cpu(cuda, rng):
    """Pooling (padded), NNSampling (both modes), GeneralisedVandermonde and
    MappedDistanceMatrix (dense, sparse, matrix-free; zonal) on CUDA against
    the same operators on the CPU, and their adjoint identity."""
    from pycsou_tpu_torch.math.green import Matern, Wendland
    from pycsou_tpu_torch.ops import GeneralisedVandermonde, MappedDistanceMatrix, NNSampling, Pooling

    pts1, pts2 = rng.uniform(0, 1, (300, 2)), rng.uniform(0, 1, (200, 2))
    grid = np.stack(np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 20), indexing="ij"), -1).reshape(-1, 2)
    sphere = pts1 / np.linalg.norm(pts1, axis=1, keepdims=True)
    builds = [
        lambda d: Pooling((70, 90), (4, 3), kind="sum"),
        lambda d: Pooling((70, 90), (4, 3), kind="mean"),
        lambda d: NNSampling(grid, pts1, dim_shape=(30, 20), adjoint_mode="sum", device=d),
        lambda d: NNSampling(grid, pts1, dim_shape=(30, 20), adjoint_mode="mean", device=d),
        lambda d: GeneralisedVandermonde([lambda t, k=k: t**k for k in range(8)], pts1[:, 0], device=d),
        lambda d: MappedDistanceMatrix(pts1, pts2, Matern(2, 0.2), device=d),
        lambda d: MappedDistanceMatrix(pts1, pts2, Wendland(2, 0.15), backend="sparse", device=d),
        lambda d: MappedDistanceMatrix(pts1, pts2, Matern(1, 0.2), backend="matrix-free", block=64, device=d),
        lambda d: MappedDistanceMatrix(sphere, sphere, Matern(1, 0.5), mode="zonal", device=d),
    ]
    for i, build in enumerate(builds):
        op_d, op_c = build(cuda), build("cpu")
        x = torch.from_numpy(rng.standard_normal(op_c.dim_shape).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal(op_c.codim_shape).astype(np.float32))
        ax, ahy = op_d.apply(x.to(cuda)), op_d.adjoint(y.to(cuda))
        _close(ax.cpu(), op_c.apply(x), rel=1e-5)
        _close(ahy.cpu(), op_c.adjoint(y), rel=1e-5)
        if i != 3:  # 'mean' is no adjoint
            lhs, rhs = float(torch.vdot(y.to(cuda).reshape(-1), ax.reshape(-1))), float(
                torch.vdot(ahy.reshape(-1), x.to(cuda).reshape(-1)))
            assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs)), i
        _close(op_d.todense().mat.cpu(), op_c.todense().mat.cpu(), rel=1e-5)


def test_stacked_pds_and_group_lasso_on_the_card(cuda, rng):
    """Poisson-TV deblurring (``PDS`` with ``K = LinOpVStack([band
    Convolve2D, Gradient])`` and ``H = ProxFuncHStack([KLDivergence,
    L21Norm])``): K1 twice an iteration and nothing else; the group LASSO
    (``APGD`` with ``L21Norm(groups=)``): K2 once an iteration, and K1 once
    for ``A^H y`` at its first gradient; each within 1e-4 of the CPU after
    10 iterations."""
    from pycsou_tpu_torch.func import KLDivergence, L21Norm, ProxFuncHStack
    from pycsou_tpu_torch.ops import LinOpVStack

    S = (96, 128)
    h = _gauss()
    x_true = np.abs(rng.standard_normal(S)).astype(np.float32) * 10
    y = rng.poisson(x_true).astype(np.float32)
    tiles = (np.arange(S[0])[:, None] // 8) * 16 + np.arange(S[1])[None, :] // 8

    def pds(d):
        H = ProxFuncHStack([KLDivergence(S, y, device=d), 0.5 * L21Norm((2,) + S, axis=0)])
        return PDS(S, G=NonNegativeOrthant(S), H=H, K=LinOpVStack([Convolve2D(S, h, device=d), Gradient(S)]))

    def lasso(d):
        return APGD(S, F=SquaredL2Loss(S, data=y, device=d) * Convolve2D(S, h, device=d),
                    G=0.01 * L21Norm(S, groups=tiles, device=d))

    kernels = [sepconv2d, sepgram2d, lasso_fista_step, tv_pds_megar_step, tv_pds_sweep_step_stats]
    for build, want, keys in ((pds, {0: 20}, ("x", "z")), (lasso, {0: 1, 1: 10}, ("x", "x_temp"))):
        solver = build(cuda)
        assert solver._fused is None
        before = [k.launches for k in kernels]
        st = solver.run_fixed(10)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == [want.get(i, 0) for i in range(len(kernels))]
        ref = build("cpu").run_fixed(10)
        for k in keys:
            _close(st[k].cpu(), ref[k], rel=1e-4)


def _fullrank(k=17, seed=7):
    """bench.py's full-rank PSF kind: |N(0, 1)| taps, unit sum."""
    h = np.abs(np.random.default_rng(seed).standard_normal((k, k))).astype(np.float32)
    return h / h.sum()


def test_sweepsp_over_the_fft_gram_launches_k16(cuda, rng):
    """``DistributedTVDeconv2D`` with a full-rank PSF on four row shards of
    one card: sweepsp over the sharded FFT Gram, K16 once a shard an
    iteration and no other kernel; within 1e-4 of the CPU after 5
    iterations."""
    S = (256, 192)
    h = _fullrank()
    y = np.abs(rng.standard_normal(S)).astype(np.float32)
    kernels = [sepconv2d, sepgram2d, tv_pds_sweep_shard_step, tv_pds_mega2_shard_step, tv_pds_megar_shard_step]

    def build(d):
        return DistributedTVDeconv2D(S, h, y, 0.05, mesh=make_mesh((4,), devices=[d] * 4),
                                     use_pallas="auto" if d == cuda else "interpret")

    solver = build(cuda)
    assert solver._sp_engine == "sweepsp" and solver._use_gram and not solver._use_band
    before = [k.launches for k in kernels]
    st = solver.run_fixed(5)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 20, 0, 0]
    ref = build(torch.device("cpu")).run_fixed(5)
    for k in ("x", "z0", "z1"):
        _close(solver._gather(st[k]).cpu(), torch.cat(ref[k]), rel=1e-4)


def test_resume_on_the_card(cuda, rng, tmp_path):
    """A checkpointed solve on the card resumed by a fresh solver: its
    shards return to the card and the result equals the uninterrupted
    solve's bit for bit (TVDeconvolution[mega3], and the sharded chain)."""
    from pycsou_tpu_torch.utils.checkpoint import load_state

    S = (128, 160)
    h = _gauss()
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    makers = {
        "mega3": lambda n: TVDeconvolution(S, y, 0.05, filt=h, max_iter=n, min_iter=n, accuracy_threshold=0.0),
        "chain": lambda n: DistributedTVDeconv2D(S, h, y, 0.05, mesh=make_mesh((4,), devices=[cuda] * 4),
                                                 use_pallas=False, max_iter=n, min_iter=n, accuracy_threshold=0.0),
    }
    for name, make in makers.items():
        d = str(tmp_path / name)
        make(40).solve(checkpoint_dir=d)
        state = load_state(f"{d}/step_40", template=make(80)._wrap_state(make(80).initial_state()))
        assert all(t.device.type == "cuda" for t in (state["x"] if name == "chain" else (state["x"],)))
        resumed, whole = make(80).solve(checkpoint_dir=d), make(80).solve()
        assert resumed.n_iter == whole.n_iter == 80
        assert torch.equal(resumed["x"], whole["x"]), name


def test_device_time_syncs_a_cuda_output(cuda):
    """``utils.profiling.device_time`` waits for the card: a call that
    sleeps ~20 ms on the device measures at least that."""
    from pycsou_tpu_torch.utils.profiling import device_time

    def slow():
        torch.cuda._sleep(int(4e7))  # cycles: ~20 ms at about 2 GHz
        return torch.ones(4, device=cuda)

    assert device_time(slow, reps=3) >= 0.01


def test_objectives_read_no_host(cuda, rng):
    """``objective`` of every solver that has one, and ``run_fixed`` with
    ``track_objective``, under ``set_sync_debug_mode("error")``: no host
    read (the solvers are built outside it, their constructors copy from
    the host)."""
    S = (128, 160)
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    m = torch.from_numpy((rng.random(S) < 0.7).astype(np.float32)).to(cuda)
    mesh = make_mesh((4,), devices=[cuda] * 4)
    solvers = [
        TVDeconvolution(S, y, 0.05, filt=_gauss()),
        TVDeconvolution(S, y, 0.05, filt=_fullrank()),
        TVDeconvolution(S, m * y, 0.05, mask=m),
        TVDeconvolution(S, m * y, 0.05, filt=_gauss(), mask=m),
        PDS(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, _gauss(), device=cuda), G=NonNegativeOrthant(S),
            H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S)),
        APGD(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, _gauss(), device=cuda), G=0.01 * L1Norm(S)),
        DistributedTVDeconv2D(S, _fullrank(), y, 0.05, mesh=mesh),
        DistributedTVDeconv2D(S, _gauss(), y, 0.05, mesh=mesh, use_pallas=False),
        Spatial2DTVDeconv2D(S, None, m * y, 0.05, mask=m, mesh=make_mesh((2, 2), ("sp0", "sp1"), [cuda] * 4)),
    ]
    states = [s.run_fixed(2) for s in solvers]
    for s in solvers:
        s.track_objective = True
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        values = [s.objective(st[s.primary_var]) for s, st in zip(solvers, states)]
        tracked = [s.run_fixed(4, state=st) for s, st in zip(solvers, states)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(v)) for v in values)
    for s, st in zip(solvers, tracked):
        last = float(st["obj_history"][st["it"] - 1])
        assert abs(last - float(s.objective(st[s.primary_var]))) <= 1e-5 * abs(last), type(s).__name__


# -- the sharded entry points: with_shardings, the sharded dense operator, the pencil FFT


def test_with_shardings_routes_onto_k14(cuda, rng):
    """``PDS(...).with_shardings(x=shard_along(mesh, "sp", 2, 0))`` on four
    shards of one card builds ``DistributedTVDeconv2D`` on megasp: K14
    four times an iteration (K1 four times for A^H y), and the hand-built
    solver's iterates bit for bit."""
    from pycsou_tpu_torch.parallel import shard_along

    S, P = (512, 384), 4
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    mesh = make_mesh((P,), devices=[cuda] * P)
    pds = PDS(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, _gauss(), device=cuda), G=NonNegativeOrthant(S),
              H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=100)
    counters = [sepconv2d, tv_pds_mega2_shard_step, tv_pds_mega3_step, tv_pds_mega2_step]
    before = [c.launches for c in counters]
    routed = pds.with_shardings(x=shard_along(mesh, "sp", 2, 0))
    st = routed.run_fixed(5)
    assert isinstance(routed._fused, DistributedTVDeconv2D) and routed._fused._sp_engine == "megasp"
    assert [c.launches - b for c, b in zip(counters, before)] == [P, 5 * P, 0, 0]
    hand = DistributedTVDeconv2D(S, pds._fused.filt, y, 0.05, mesh=mesh, tau=pds._fused.tau, rho=pds.rho,
                                 max_iter=100)
    assert torch.equal(routed.postprocess(st)["x"], hand.postprocess(hand.run_fixed(5))["x"])


@pytest.mark.parametrize("row_axis,col_axis,mesh", [("sp", None, (4,)), (None, "sp", (4,)), ("r", "c", (2, 2))])
def test_sharded_dense_on_the_card(cuda, rng, row_axis, col_axis, mesh):
    """``ShardedDenseOperator`` on four blocks of one card against
    ``torch.matmul`` of the whole matrix (full f32), apply and adjoint."""
    from pycsou_tpu_torch.parallel import ShardedDenseOperator
    from pycsou_tpu_torch.utils.device import full_f32

    names = ("sp",) if len(mesh) == 1 else ("r", "c")
    M = torch.from_numpy(rng.standard_normal((1024, 768)).astype(np.float32)).to(cuda)
    op = ShardedDenseOperator(M, mesh=make_mesh(mesh, names, devices=[cuda] * 4), row_axis=row_axis,
                              col_axis=col_axis)
    x = torch.from_numpy(rng.standard_normal(768).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).to(cuda)
    with full_f32():
        want_x, want_y = M @ x, M.T @ y
    _close(op.apply(x), want_x, rel=1e-5)
    _close(op.adjoint(y), want_y, rel=1e-5)
    assert op.apply(x).device.type == "cuda"


def test_pencil_conv_on_the_card(cuda, rng):
    """``PencilCircularConv2D`` on four shards of one card against
    ``CircularConvolve``: apply, adjoint, gram and the damped pinv."""
    from pycsou_tpu_torch.ops import CircularConvolve
    from pycsou_tpu_torch.parallel import PencilCircularConv2D

    S = (256, 384)
    op = PencilCircularConv2D(S, _gauss(), mesh=make_mesh((4,), devices=[cuda] * 4))
    ref = CircularConvolve(S, _gauss(), device=cuda)
    x = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(cuda)
    _close(op.apply(x), ref.apply(x), rel=1e-5)
    _close(op.adjoint(x), ref.adjoint(x), rel=1e-5)
    _close(op.gram.apply(x), ref.adjoint(ref.apply(x)), rel=1e-5)
    _close(op.pinv(x, damp=1e-3), ref.pinv(x, damp=1e-3), rel=1e-5)


_DEFAULT_BACKEND_WORKER = r"""
import sys

import numpy as np
import torch

from pycsou_tpu_torch.parallel import NamedSharding, PartitionSpec, distributed_init, make_mesh, pdot, psum

coord, pid = sys.argv[1], int(sys.argv[2])
torch.cuda.set_device(0)  # each process's card, as torchrun users set it: one card here, for both
distributed_init(coordinator_address=coord, num_processes=2, process_id=pid)  # the default backend
assert torch.distributed.get_backend() == "cpu:gloo,cuda:nccl", torch.distributed.get_backend()
cards = make_mesh()
assert cards.size == 2 and cards.local_positions == (pid,), cards
assert cards.local_device == torch.device("cuda", torch.cuda.current_device()) and cards.backend == "nccl"
mesh = make_mesh((4,), ("d",), devices=["cpu"] * 2)
assert mesh.backend == "gloo", mesh.backend
sh = NamedSharding(mesh, PartitionSpec("d"))
blocks = sh.split(torch.arange(8.0))
assert float(psum([b.sum() for b in blocks], mesh)) == 28.0
rng = np.random.default_rng(5)
a, b = rng.standard_normal(64), rng.standard_normal(64)
got = float(pdot(sh.split(torch.from_numpy(a)), sh.split(torch.from_numpy(b)), mesh=mesh))
assert abs(got - float(a @ b)) <= 1e-5 * abs(float(a @ b)), (got, float(a @ b))
assert torch.equal(sh.join(blocks), torch.arange(8.0))
torch.distributed.destroy_process_group()
print(f"proc {pid} OK", flush=True)
"""


def test_distributed_init_default_backend_with_the_card_visible(cuda, tmp_path):
    """Two processes with the card visible and ``distributed_init``'s default
    backend (``cpu:gloo,cuda:nccl``): a mesh of CPU positions sums, dots
    and joins across them over gloo, and ``make_mesh()`` holds each
    process's current card once (no CUDA collective runs: NCCL refuses two
    ranks on one card)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    script = tmp_path / "worker.py"
    script.write_text(_DEFAULT_BACKEND_WORKER)
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [root, env.get("PYTHONPATH", "")] if p)
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(i)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    joined = "\n".join(outs)
    assert all(p.returncode == 0 for p in procs), joined
    assert all("OK" in o for o in outs), joined


def test_plain_switches_raise_on_the_card(cuda, rng):
    """``TVDeconvolution(use_pallas=False)`` and ``stencil="xla"`` take the
    plain engine, which runs on CPU tensors only: on the card they raise
    the ``ValueError`` that names ``device="cpu"`` (a deliberate
    difference: the reference runs its XLA stencil on any backend);
    ``"auto"`` and ``use_pallas=True`` keep the ladder's pick."""
    from pycsou_tpu_torch.opt import TVDeconvolution

    y = torch.as_tensor(rng.standard_normal((64, 64)), dtype=torch.float32, device=cuda)
    h = np.outer(*(2 * [np.hanning(7)[1:-1]])).astype(np.float32)
    for kw in (dict(use_pallas=False), dict(stencil="xla"), dict(stencil="xla", use_pallas=True),
               dict(stencil="plain")):
        with pytest.raises(ValueError, match='device="cpu"'):
            TVDeconvolution((64, 64), y, 0.05, filt=h, **kw)
    pick = TVDeconvolution((64, 64), y, 0.05, filt=h).stencil_mode
    assert TVDeconvolution((64, 64), y, 0.05, filt=h, use_pallas=True).stencil_mode == pick == "mega3"
    with pytest.raises(ValueError, match="use_pallas=False"):
        TVDeconvolution((64, 64), y, 0.05, filt=h, stencil="megar", use_pallas=False)


def _port_modules():
    import pathlib

    import pycsou_tpu_torch

    root = pathlib.Path(pycsou_tpu_torch.__file__).parent
    mods = [".".join(p.relative_to(root.parent).with_suffix("").parts) for p in sorted(root.rglob("*.py"))]
    return [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]


@pytest.mark.parametrize("modname", _port_modules())
def test_module_doctests_on_the_card(cuda, modname):
    """Every docstring example of the port with the port's default device
    left at ``cuda``: the examples' tensors live on the card."""
    import doctest
    import importlib

    from pycsou_tpu_torch.utils.device import get_default_device, set_default_device

    set_default_device(None)
    assert get_default_device().type == "cuda"
    runner = doctest.testmod(importlib.import_module(modname), optionflags=doctest.NORMALIZE_WHITESPACE,
                             verbose=False)
    assert runner.failed == 0, f"{runner.failed} doctest failures in {modname} on the card"


def test_program_spans_on_the_card(cuda, rng):
    """The program's spans (``utils.profiling``) on a 4096² main-path ``PDS``
    solve under a CUDA profile: every K10 launch (its ``cudaLaunchKernel``
    runtime event, matched to the kernel by correlation id) lies inside a
    ``solve.enqueue`` record, and every record starts within 100 µs of its
    own annotation event; without a profiler ``annotate`` costs at most
    0.5 µs a call (the median of 10⁵ calls, in batches of 1000)."""
    import statistics
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pycsou_tpu_torch.utils import profiling

    S = (4096, 4096)
    y = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32)).to(cuda)
    p = PDS(S, F=SquaredL2Loss(S, data=y) * Convolve2D(S, _gauss(), device=cuda), G=NonNegativeOrthant(S),
            H=0.05 * L21Norm((2,) + S, axis=0), K=Gradient(S), max_iter=64, min_iter=64, accuracy_threshold=0.0)
    assert p._fused.stencil_mode == "mega3"
    p.solve()  # the kernels built and loaded
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler's first range carries its cold start (0.3-1.2 ms
        # between the record's clock read and the event's), not the clocks'
        with profiling.annotate("warm"):
            pass
        info = p.solve()
    torch.cuda.synchronize()
    assert info.n_iter == 64
    recs, counts = profiling.records()[1:], profiling.counters()
    profiling.reset()
    enqueues = [r for r in recs if r.name == "solve.enqueue"]
    assert len(enqueues) == 4 and counts == {"solve.host_reads": 4 + 2}
    events = list(prof.profiler.kineto_results.events())
    k10 = {e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA and "tv_mega3" in e.name()}
    launches = [e for e in events if e.device_type() == DeviceType.CPU and e.name().startswith("cudaLaunch")
                and e.correlation_id() in k10]
    assert len(k10) == 32 and len(launches) == 32, (len(k10), len(launches))
    for e in launches:
        s = e.start_ns()
        assert any(r.start_ns <= s and s + e.duration_ns() <= r.end_ns for r in enqueues), s
    marks = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.is_user_annotation():
            marks.setdefault(e.name(), []).append(e.start_ns())
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r.start_ns)
    assert len(marks.pop("warm", ())) == 1
    for name, starts in by_name.items():
        assert len(starts) == len(marks.get(name, ())), name
        for rec, ev in zip(sorted(starts), sorted(marks[name])):
            assert abs(ev - rec) <= 100_000, (name, ev - rec)
    per_call = []
    for _ in range(100):
        t0 = time.perf_counter_ns()
        for _ in range(1000):
            with profiling.annotate("solve.enqueue"):
                pass
        per_call.append((time.perf_counter_ns() - t0) / 1000)
    assert statistics.median(per_call) <= 500, statistics.median(per_call)
    assert profiling.records() == []


# -- several cards in one process: a mesh over cuda:0..3 -------------------------------


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        pytest.skip(f"needs four CUDA cards in one process ({n} visible)")
    return [torch.device("cuda", i) for i in range(4)]


def test_routed_solve_over_four_cards_is_the_one_card_mesh(four_cards):
    """``PDS(...).with_shardings`` at 8192² on a mesh over cuda:0..3 (megasp,
    K14 on each card, halos copied between cards, the partial sums folded
    in mesh order on cuda:0) against the same four positions on cuda:0: x,
    the duals, the metric history and ``converged_at`` bit for bit; each
    step's exchange copies 18 halo blocks of 16 rows between cards."""
    from torch.profiler import ProfilerActivity, profile

    from pycsou_tpu_torch.parallel import NamedSharding, PartitionSpec
    from pycsou_tpu_torch.utils import profiling

    S = (8192, 8192)
    dev0 = four_cards[0]
    g = torch.Generator(device=dev0).manual_seed(26)
    y = torch.randn(S, generator=g, device=dev0).abs_()
    A = Convolve2D(S, _gauss(), device=dev0)
    y = A(y) + 0.01 * torch.randn(S, generator=g, device=dev0)

    def routed(devices):
        p = PDS(S, F=SquaredL2Loss(S, data=y) * A, G=NonNegativeOrthant(S), H=0.05 * L21Norm((2,) + S, axis=0),
                K=Gradient(S), max_iter=400, min_iter=50, accuracy_threshold=1e-4)
        r = p.with_shardings(x=NamedSharding(make_mesh((4,), ("sp",), devices=devices), PartitionSpec("sp", None)))
        assert isinstance(r._fused, DistributedTVDeconv2D) and r._fused.stencil_mode == "megasp"
        return r

    spread, one = routed(four_cards), routed([dev0] * 4)
    a, b = spread.solve(), one.solve()
    assert a.converged_at is not None and a.converged_at == b.converged_at and a.n_iter == b.n_iter
    assert np.array_equal(a.history, b.history)
    assert a["x"].device == dev0 and torch.equal(a["x"], b["x"]) and torch.equal(a["z"], b["z"])
    assert torch.cuda.current_device() == 0
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        spread.run_fixed(2)
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset()
    assert counts.get("sp.halo_bytes") == 2 * 18 * 16 * S[1] * 4


# one case of each launcher's card test (K1-K18, stats_fold), run on cuda:1 while cuda:0 is current
_ANOTHER_CARD = [
    ("test_kernels_match_plain", ((100, 130), 2, 15, 15)),
    ("test_masked_kernels_match_plain", ((100, 130), True, True)),
    ("test_sweepm2_tiles_match_plain", (97, 131, True, True)),
    ("test_megarm_matches_plain", ((100, 130), 2, 9, 7)),
    ("test_fista_kernel_matches_plain", ((100, 130), 2, 9, 7)),
    ("test_pmyula_kernel_matches_plain", ((100, 130), 2, 9, 7)),
    ("test_rank1_kernels_match_plain", ((100, 130), 15, 15, True, True)),
    ("test_mega3_walker_matches_plain", ((65, 65), 15, 15, True, True)),
    ("test_shard_kernels_match_plain", (4, (128, 130), 15, 15)),
    ("test_block_kernel_matches_plain", ((96, 132), (2, 2), 2, 9, 4)),
    ("test_sepgram_apply_matches_plain_and_k2", ((100, 130), 2, 7, 7)),
]


@pytest.mark.parametrize("name,args", _ANOTHER_CARD, ids=[n for n, _ in _ANOTHER_CARD])
def test_launchers_run_on_a_card_that_is_not_current(four_cards, name, args):
    """Each launcher's card test with every tensor on cuda:1 while cuda:0
    is the current card: the launch, its shared-memory opt-in and its SM
    count act on the tensors' card (``kernels/_build.py`` ``launch``), and
    the current card is cuda:0 again after it."""
    torch.cuda.set_device(0)
    globals()[name](four_cards[1], np.random.default_rng(17), *args)
    torch.cuda.synchronize(four_cards[1])
    assert torch.cuda.current_device() == 0
