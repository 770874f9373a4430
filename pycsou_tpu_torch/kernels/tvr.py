"""Fused TV primal-dual step for any PSF of rank <= 4 (K4) and its plain
version.

One pass computes the data gradient ``g = 2 (A^H A x - atb)`` (forward
convolution, then the adjoint convolution with the 2x folded into its row
taps) and feeds it straight into the stencil of ``kernels/tv.py``, with the
stopping-metric partial sums.  ``t = A x`` and g never reach device memory:
7 image streams a step (x, atb, z0, z1 in; x', z0', z1' out).
"""
from __future__ import annotations

import torch

from pycsou_tpu_torch.kernels._build import TILE, check, library, stream_of
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    _check_device,
    _check_image,
    gram_taps,
    sepgram2d_plain,
)
from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_step_stats_plain

__all__ = ["tv_pds_megar_step", "tv_pds_megar_step_plain"]


def tv_pds_megar_step_plain(x, z0, z1, atb, fwd: SepFactors, adj2: SepFactors, *, tau, sigma,
                            rho, lam, nonneg=True, iso=True):
    """Plain PyTorch version of K4: the Gram gradient by two plain
    convolutions, then the plain stencil step."""
    g = sepgram2d_plain(x, fwd, adj2, atb)
    return tv_pds_sweep_step_stats_plain(
        x, z0, z1, g, tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso
    )


def tv_pds_megar_step(x, z0, z1, atb, fwd: SepFactors, adj2: SepFactors, *, tau, sigma, rho,
                      lam, nonneg=True, iso=True):
    """K4: one TV PDS iteration, ``(x', z0', z1', stats (6,))`` in new
    buffers; ``adj2 = fwd.adjoint(2.0)`` carries the gradient's 2x.

    Replaces ``pycsou_tpu/kernels/tvr.py`` ``tv_pds_megar_step``
    (``_tv_megar_kernel`` via ``_megar_call``), without its ``mask=``
    ('megarm') form.  Bound by device memory: 7 image streams a step.
    Each block reads x over the forward + adjoint reach + 1 around its
    tile and its neighbours' z, so the outputs never alias the inputs."""
    for name, t in (("x", x), ("z0", z0), ("z1", z1), ("atb", atb)):
        _check_image(t, name, like=None if name == "x" else x)
    _check_device(x, fwd, adj2)
    taps = gram_taps(fwd, adj2)
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    if x.device.type == "cpu":
        return tv_pds_megar_step_plain(x, z0, z1, atb, fwd, adj2, **kw)
    H, W = x.shape
    xo, z0o, z1o = (torch.empty_like(x) for _ in range(3))
    nblocks = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=x.device)
    stats = torch.empty(6, dtype=torch.float32, device=x.device)
    err = library().pct_tv_megar(
        x.data_ptr(), z0.data_ptr(), z1.data_ptr(), atb.data_ptr(),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        H, W, taps.data_ptr(), fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov,
        2.0, float(tau), float(sigma), float(rho), float(lam), int(bool(nonneg)), int(bool(iso)),
        stream_of(x),
    )
    check(err, "tv_pds_megar_step")
    tv_pds_megar_step.launches += 1
    return xo, z0o, z1o, stats


tv_pds_megar_step.launches = 0
