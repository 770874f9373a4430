"""The port's kernels (pycsou_tpu_torch.kernels) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions K1-K4 (and the stencil twin) to the JAX
reference.  Tolerances: rtol 3e-4 / atol 3e-5 for images (the TPU kernels'
bf16x3 dots against f32 convolutions), rtol 1e-3 for the metric partial
sums (different summation order), rtol 1e-5 for the stencil twin (the same
f32 arithmetic as tv_pds_stencil_step_xla).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycsou_tpu.kernels.conv2d import make_sepconv_plan_pair, sepconv2d_sweep, sepgram2d_sweep
from pycsou_tpu.kernels.tv import tv_pds_stencil_step_xla
from pycsou_tpu.kernels.tv import tv_pds_sweep_step_stats as jax_sweep_stats
from pycsou_tpu.kernels.tvr import make_megar_plan, tv_pds_megar_step as jax_megar
from pycsou_tpu.ops.conv import lowrank_factors
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    sepconv2d,
    sepconv2d_plain,
    sepgram2d,
    sepgram2d_plain,
)
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_stencil_step_plain,
    tv_pds_stencil_step_sweep,
    tv_pds_sweep_step_stats,
    tv_pds_sweep_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tvr import tv_pds_megar_step, tv_pds_megar_step_plain

RTOL, ATOL = 3e-4, 3e-5
KW = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.1)


def _psf(rng, rank, K0, K1):
    u = rng.standard_normal((K0, rank)) * 0.3
    v = rng.standard_normal((K1, rank)) * 0.3
    filt = (u @ v.T).astype(np.float32)
    return filt / np.abs(filt).sum()


def _factors(filt):
    us, vs = lowrank_factors(filt)
    fwd = SepFactors(us, vs, filt.shape[0] // 2, filt.shape[1] // 2, "cpu")
    return us, vs, fwd


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("rank,K0,K1", [(1, 9, 9), (2, 9, 7), (2, 8, 6)])
def test_sepconv_plain_matches_pallas(rng, rank, K0, K1):
    """K1 forward and adjoint (flipped taps at K - 1 - o), even K included."""
    H, W = 96, 384
    filt = _psf(rng, rank, K0, K1)
    us, vs, fwd = _factors(filt)
    Bf, Cf, Ba, Ca, r = make_sepconv_plan_pair(us, vs, (H, W))
    x = rng.standard_normal((H, W)).astype(np.float32)
    _close(sepconv2d_plain(_t(x), fwd), sepconv2d_sweep(jnp.asarray(x), Bf, Cf, r=r, interpret=True))
    _close(sepconv2d_plain(_t(x), fwd.adjoint()), sepconv2d_sweep(jnp.asarray(x), Ba, Ca, r=r, interpret=True))


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("with_atb", [False, True])
def test_sepgram_plain_matches_pallas(rng, rank, with_atb):
    """K2: the Gram, and the fused gradient 2 (A^H A x - atb)."""
    H, W = 96, 384
    filt = _psf(rng, rank, 11, 13)
    us, vs, fwd = _factors(filt)
    scale = 2.0 if with_atb else 1.0
    Bf, Cf, Ba, Ca, r = make_sepconv_plan_pair(us, vs, (H, W), adj_scale=scale)
    x = rng.standard_normal((H, W)).astype(np.float32)
    atb = rng.standard_normal((H, W)).astype(np.float32) if with_atb else None
    want = sepgram2d_sweep(
        jnp.asarray(x), Bf, Cf, Ba, Ca, r=r, interpret=True,
        atb=None if atb is None else jnp.asarray(atb),
    )
    got = sepgram2d_plain(_t(x), fwd, fwd.adjoint(scale), None if atb is None else _t(atb))
    _close(got, want)


def _state(rng, H, W):
    x = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    z = (rng.standard_normal((2, H, W)) * 0.05).astype(np.float32)
    z[0, -1] = 0.0  # the dual invariants the solvers keep
    z[1, :, -1] = 0.0
    return x, z


def _stats_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want)[0, :6], rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("nonneg", [True, False])
def test_sweep_stats_plain_matches_pallas(rng, iso, nonneg):
    """K3: the stencil step from a given gradient, with the stats."""
    H, W = 64, 256
    x, z = _state(rng, H, W)
    g = rng.standard_normal((H, W)).astype(np.float32)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jx, jz0, jz1, jst = jax_sweep_stats(
        jnp.asarray(x), jnp.asarray(z[0]), jnp.asarray(z[1]), jnp.asarray(g), interpret=True, **kw
    )
    tx, tz0, tz1, tst = tv_pds_sweep_step_stats_plain(_t(x), _t(z[0]), _t(z[1]), _t(g), **kw)
    _close(tx, jx)
    _close(tz0, jz0)
    _close(tz1, jz1)
    _stats_close(tst, jst)


@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("nonneg", [True, False])
def test_stencil_twin_matches_xla(rng, iso, nonneg):
    """The plain twin is tv_pds_stencil_step_xla, to f32 rounding."""
    H, W = 24, 40
    x, z = _state(rng, H, W)
    g = rng.standard_normal((H, W)).astype(np.float32)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jx, jz = tv_pds_stencil_step_xla(jnp.asarray(x), jnp.asarray(z), jnp.asarray(g), **kw)
    tx, tz = tv_pds_stencil_step_plain(_t(x), _t(z), _t(g), **kw)
    _close(tx, jx, rtol=1e-5, atol=1e-6)
    _close(tz, jz, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "rank,iso,nonneg", [(1, True, True), (2, True, True), (2, False, True), (1, False, False)]
)
def test_megar_plain_matches_pallas(rng, rank, iso, nonneg):
    """K4: Gram gradient + stencil + stats in one step, chained over two
    iterations."""
    H, W = 96, 384
    filt = _psf(rng, rank, 9, 9)
    us, vs, fwd = _factors(filt)
    Bf, Cf, Ba, Ca, R = make_megar_plan(us, vs, (H, W))
    adj2 = fwd.adjoint(2.0)
    x, _ = _state(rng, H, W)
    atb = rng.standard_normal((H, W)).astype(np.float32)
    kw = dict(KW, nonneg=nonneg, iso=iso)
    jx, jz0, jz1 = jnp.asarray(x), jnp.zeros((H, W)), jnp.zeros((H, W))
    tx, tz0, tz1 = _t(x), torch.zeros(H, W), torch.zeros(H, W)
    for _ in range(2):
        jx, jz0, jz1, jst = jax_megar(jx, jz0, jz1, jnp.asarray(atb), Bf, Cf, Ba, Ca, mega_r=R, interpret=True, **kw)
        tx, tz0, tz1, tst = tv_pds_megar_step_plain(tx, tz0, tz1, _t(atb), fwd, adj2, **kw)
        _close(tx, jx)
        _close(tz0, jz0)
        _close(tz1, jz1)
        _stats_close(tst, jst)


def test_cpu_wrappers_run_the_plain_versions(rng):
    """On CPU tensors each wrapper returns exactly its plain version, and
    launches nothing (its counter stays put)."""
    H, W = 40, 72
    _, _, fwd = _factors(_psf(rng, 2, 7, 5))
    adj2 = fwd.adjoint(2.0)
    x, z = (_t(a) for a in _state(rng, H, W))
    g = _t(rng.standard_normal((H, W)))
    counts = [f.launches for f in (sepconv2d, sepgram2d, tv_pds_sweep_step_stats, tv_pds_megar_step)]
    assert torch.equal(sepconv2d(x, fwd), sepconv2d_plain(x, fwd))
    assert torch.equal(sepgram2d(x, fwd, adj2, g), sepgram2d_plain(x, fwd, adj2, g))
    for a, b in zip(
        tv_pds_sweep_step_stats(x, z[0].contiguous(), z[1].contiguous(), g, **KW),
        tv_pds_sweep_step_stats_plain(x, z[0], z[1], g, **KW),
    ):
        assert torch.equal(a, b)
    for a, b in zip(
        tv_pds_megar_step(x, z[0].contiguous(), z[1].contiguous(), g, fwd, adj2, **KW),
        tv_pds_megar_step_plain(x, z[0], z[1], g, fwd, adj2, **KW),
    ):
        assert torch.equal(a, b)
    xs, zs = tv_pds_stencil_step_sweep(x, z, g, **KW)
    xp, zp = tv_pds_stencil_step_plain(x, z, g, **KW)
    assert torch.equal(xs, xp) and torch.equal(zs, zp)
    assert counts == [f.launches for f in (sepconv2d, sepgram2d, tv_pds_sweep_step_stats, tv_pds_megar_step)]


def test_wrappers_check_their_inputs(rng):
    _, _, fwd = _factors(_psf(rng, 1, 5, 5))
    x = torch.zeros(16, 24)
    with pytest.raises(ValueError, match="float32"):
        sepconv2d(x.double(), fwd)
    with pytest.raises(ValueError, match="contiguous"):
        sepconv2d(torch.zeros(24, 16).T, fwd)
    with pytest.raises(ValueError, match="expected"):
        sepgram2d(x, fwd, fwd.adjoint(2.0), torch.zeros(16, 23))
    with pytest.raises(ValueError, match="expected"):
        tv_pds_sweep_step_stats(x, x, torch.zeros(15, 24), x, **KW)
    with pytest.raises(ValueError, match="adjoint"):
        sepgram2d(x, fwd, SepFactors(np.ones((3, 1)), np.ones((5, 1)), 1, 2, "cpu"))


@pytest.mark.parametrize(
    "u,v,msg",
    [
        (np.ones((5, 5)), np.ones((5, 5)), "rank"),  # rank 5
        (np.ones((33, 1)), np.ones((5, 1)), "taps"),  # reach 16 > 15
        (np.ones((5, 2)), np.ones((5, 1)), "rank"),
    ],
)
def test_factor_gates_raise(u, v, msg):
    with pytest.raises(ValueError, match=msg):
        SepFactors(u, v, u.shape[0] // 2, v.shape[0] // 2, "cpu")


_FLAGS = """
import torch
def flags():
    b = torch.backends
    owners = (b, b.cuda.matmul, b.cudnn, getattr(b.cudnn, "conv", None), getattr(b.cudnn, "rnn", None))
    return tuple(getattr(o, "fp32_precision", None) for o in owners)
"""


def test_full_f32_is_scoped():
    """Importing the port changes no global PyTorch setting, and the plain
    convolutions switch TF32 off only inside their own calls."""
    import subprocess
    import sys
    from pathlib import Path

    from pycsou_tpu_torch.utils.device import full_f32

    code = _FLAGS + (
        "before = flags()\n"
        "import pycsou_tpu_torch, pycsou_tpu_torch.opt, pycsou_tpu_torch.kernels.tvr\n"
        "assert flags() == before, (before, flags())\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])
    scope = {}
    exec(_FLAGS, scope)
    before = scope["flags"]()
    with full_f32():
        assert scope["flags"]()[3] in ("ieee", None)
        if scope["flags"]()[3] is None:
            assert torch.backends.cudnn.allow_tf32 is False
    assert scope["flags"]() == before
    h = np.ones((3, 3), np.float32) / 9
    sepconv2d_plain(torch.ones(8, 16), _factors(h)[2])
    assert scope["flags"]() == before
