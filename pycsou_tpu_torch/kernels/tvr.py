"""Fused TV primal-dual step for any PSF of rank <= 4 (K4), its masked form
(K7) and their plain versions.

One pass computes the data gradient ``g = 2 (A^H A x - atb)`` (forward
convolution, then the adjoint convolution with the 2x folded into its row
taps) and feeds it straight into the stencil of ``kernels/tv.py``, with the
stopping-metric partial sums.  ``t = A x`` and g never reach device memory:
7 image streams a step (x, atb, z0, z1 in; x', z0', z1' out).  K7 multiplies
a data mask onto ``t`` between the two convolutions, for the Gram
``A^H diag(m) A`` of blurred, partially sampled data (8 streams).
"""
from __future__ import annotations

import torch

from pycsou_tpu_torch.kernels._build import TILE, check, library, stream_of
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    _check_device,
    _check_image,
    gram_taps,
    sepconv2d_plain,
    sepgram2d_plain,
)
from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_step_stats_plain

__all__ = [
    "tv_pds_megar_step",
    "tv_pds_megar_step_plain",
    "tv_pds_megarm_step",
    "tv_pds_megarm_step_plain",
]


def tv_pds_megar_step_plain(x, z0, z1, atb, fwd: SepFactors, adj2: SepFactors, *, tau, sigma,
                            rho, lam, nonneg=True, iso=True):
    """Plain PyTorch version of K4: the Gram gradient by two plain
    convolutions, then the plain stencil step."""
    g = sepgram2d_plain(x, fwd, adj2, atb)
    return tv_pds_sweep_step_stats_plain(
        x, z0, z1, g, tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso
    )


def tv_pds_megarm_step_plain(x, z0, z1, m, atb, fwd: SepFactors, adj2: SepFactors, *, tau,
                             sigma, rho, lam, nonneg=True, iso=True):
    """Plain PyTorch version of K7: ``g = 2 A^H(m A x) - 2 atb`` by two
    plain convolutions (``adj2`` carries the 2x), then the plain stencil
    step."""
    g = sepconv2d_plain(m * sepconv2d_plain(x, fwd), adj2) - 2.0 * atb
    return tv_pds_sweep_step_stats_plain(
        x, z0, z1, g, tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso
    )


def _check_megar(x, z0, z1, m, atb, fwd, adj2):
    """Checks shared by K4 and K7; returns the packed taps."""
    images = [("x", x), ("z0", z0), ("z1", z1), ("atb", atb)]
    if m is not None:
        images.append(("m", m))
    for name, t in images:
        _check_image(t, name, like=None if name == "x" else x)
    _check_device(x, fwd, adj2)
    return gram_taps(fwd, adj2)


def _launch_megar(fn, x, z0, z1, m, atb, fwd, adj2, taps, kw):
    """Launch of K4 (``m`` None) or K7; counts on ``fn``."""
    H, W = x.shape
    xo, z0o, z1o = (torch.empty_like(x) for _ in range(3))
    nblocks = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=x.device)
    stats = torch.empty(6, dtype=torch.float32, device=x.device)
    err = library().pct_tv_megar(
        x.data_ptr(), z0.data_ptr(), z1.data_ptr(), 0 if m is None else m.data_ptr(), atb.data_ptr(),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        H, W, taps.data_ptr(), fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov,
        2.0, float(kw["tau"]), float(kw["sigma"]), float(kw["rho"]), float(kw["lam"]),
        int(bool(kw["nonneg"])), int(bool(kw["iso"])), stream_of(x),
    )
    check(err, fn.__name__)
    fn.launches += 1
    return xo, z0o, z1o, stats


def tv_pds_megar_step(x, z0, z1, atb, fwd: SepFactors, adj2: SepFactors, *, tau, sigma, rho,
                      lam, nonneg=True, iso=True, mask=None):
    """K4: one TV PDS iteration, ``(x', z0', z1', stats (6,))`` in new
    buffers; ``adj2 = fwd.adjoint(2.0)`` carries the gradient's 2x.  With
    ``mask=m`` it is :func:`tv_pds_megarm_step` (K7).

    Replaces ``pycsou_tpu/kernels/tvr.py`` ``tv_pds_megar_step``
    (``_tv_megar_kernel`` via ``_megar_call``).  Bound by device memory: 7
    image streams a step.  Each block reads x over the forward + adjoint
    reach + 1 around its tile and its neighbours' z, so the outputs never
    alias the inputs."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    if mask is not None:
        return tv_pds_megarm_step(x, z0, z1, mask, atb, fwd, adj2, **kw)
    taps = _check_megar(x, z0, z1, None, atb, fwd, adj2)
    if x.device.type == "cpu":
        return tv_pds_megar_step_plain(x, z0, z1, atb, fwd, adj2, **kw)
    return _launch_megar(tv_pds_megar_step, x, z0, z1, None, atb, fwd, adj2, taps, kw)


tv_pds_megar_step.launches = 0


def tv_pds_megarm_step(x, z0, z1, m, atb, fwd: SepFactors, adj2: SepFactors, *, tau, sigma,
                       rho, lam, nonneg=True, iso=True):
    """K7: K4 with the data mask ``m`` multiplied onto ``t = A x`` after the
    'same' crop, so the gradient is ``2 (A^H diag(m) A x - atb)``;
    ``(x', z0', z1', stats (6,))`` in new buffers.

    Replaces ``pycsou_tpu/kernels/tvr.py`` ``tv_pds_megar_step(...,
    mask=m)`` ('megarm', ``_tv_megar_kernel`` with ``masked``).  Bound by
    device memory: K4's 7 image streams and m."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    taps = _check_megar(x, z0, z1, m, atb, fwd, adj2)
    if x.device.type == "cpu":
        return tv_pds_megarm_step_plain(x, z0, z1, m, atb, fwd, adj2, **kw)
    return _launch_megar(tv_pds_megarm_step, x, z0, z1, m, atb, fwd, adj2, taps, kw)


tv_pds_megarm_step.launches = 0
