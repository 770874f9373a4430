"""Fused TV primal-dual step for any PSF of rank <= 4 (K4), its masked form
(K7) and their plain versions.

One pass computes the data gradient ``g = 2 (A^H A x - atb)`` (forward
convolution, then the adjoint convolution with the 2x folded into its row
taps) and feeds it straight into the stencil of ``kernels/tv.py``, with the
stopping-metric partial sums.  ``t = A x`` and g never reach device memory:
7 image streams a step (x, atb, z0, z1 in; x', z0', z1' out).  K7 multiplies
a data mask onto ``t`` between the two convolutions, for the Gram
``A^H diag(m) A`` of blurred, partially sampled data (8 streams).  K15 is
K4 on the core rows of a row shard of the image (the shard conventions of
``kernels/tv.py``), K17 K4 on the core of a block of a 2-D mesh: its
inputs are lane-extended by ``HALO_COLS`` columns of the left and right
neighbours (the reference's 128 lanes: ``_megar_call`` ``core_l``).
"""
from __future__ import annotations

import torch

from pycsou_tpu_torch.kernels._build import TILE, launch
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    _check_device,
    _check_image,
    gram_taps,
    sepconv2d_plain,
    sepgram2d_plain,
)
from pycsou_tpu_torch.kernels.tv import (
    _launch_shard,
    check_shard,
    shard_plain,
    tv_pds_sweep_step_stats_plain,
)

__all__ = [
    "HALO_COLS",
    "tv_pds_megar_step",
    "tv_pds_megar_step_plain",
    "tv_pds_megarm_step",
    "tv_pds_megarm_step_plain",
    "tv_pds_megar_shard_step",
    "tv_pds_megar_shard_step_plain",
    "tv_pds_megar_shard2d_step",
    "tv_pds_megar_shard2d_step_plain",
]

# the column halo of K17's blocks: K4 reads x over the PSF's columns (<= 31)
# each side of a tile, plus one for the stencil, so 32 covers every PSF it
# takes (the reference's one 128-lane chunk, tvr.py:416-431)
HALO_COLS = 32


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
    launch(
        "pct_tv_megar", fn.__name__, x,
        x.data_ptr(), z0.data_ptr(), z1.data_ptr(), 0 if m is None else m.data_ptr(), atb.data_ptr(),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        H, W, taps.ctypes.data, fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov,
        2.0, float(kw["tau"]), float(kw["sigma"]), float(kw["rho"]), float(kw["lam"]),
        int(bool(kw["nonneg"])), int(bool(kw["iso"])),
    )
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


def tv_pds_megar_shard_step_plain(x, z0, z1, atb_ext, halos, fwd: SepFactors, adj2: SepFactors, off, *,
                                  H_global, **kw):
    """Plain PyTorch version of K15: K4's plain version on the
    halo-extended shard (``kernels.tv.shard_plain``)."""
    xt, xb, z0t, z0b, z1t, z1b = halos
    ext = (torch.cat([xt, x, xb]), torch.cat([z0t, z0, z0b]), torch.cat([z1t, z1, z1b]), atb_ext)
    return shard_plain(lambda *a: tv_pds_megar_step_plain(*a, fwd, adj2, **kw), ext, off, x.shape[0],
                       H_global)


def tv_pds_megar_shard_step(x, z0, z1, atb_ext, halos, fwd: SepFactors, adj2: SepFactors, off, *,
                            H_global, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K15: K4 on the core rows of a row shard; ``halos = (xt, xb, z0t, z0b,
    z1t, z1b)``, (R, W) blocks with R >= the PSF's rows (32 covers every
    PSF K4 takes), ``atb_ext`` the (h_loc + 2R, W) halo-extended atb;
    ``(x', z0', z1', stats (6,))`` of the core in new buffers.

    Replaces ``pycsou_tpu/kernels/tvr.py`` ``tv_pds_megar_shard_step``
    (``_tv_megar_kernel`` in shard mode via ``_megar_call``).  Bound by
    device memory: K4's 7 streams over the core and its halos; each block
    recomputes the Gram of its tile from the halos."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _, row0 = check_shard(x, dict(z0=z0, z1=z1), halos, 6, off, H_global, fwd.Ku, atb_ext)
    taps = gram_taps(fwd, adj2)
    _check_device(x, fwd, adj2)
    if x.device.type == "cpu":
        return tv_pds_megar_shard_step_plain(x, z0, z1, atb_ext, halos, fwd, adj2, off, H_global=H_global,
                                             **kw)
    args = (taps.ctypes.data, fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov, 2.0)
    return _launch_shard(tv_pds_megar_shard_step, "pct_tv_megar_shard", x, (x, z0, z1, atb_ext), halos,
                         row0, H_global, args, kw)


tv_pds_megar_shard_step.launches = 0


# -- K17: a block of a 2-D mesh --------------------------------------------------


def check_shard2d(x_ext, images, halos, off, H_global: int, W_global: int, reach_r: int, reach_c: int,
                  atb_ext):
    """Checks of K17; returns ``(R, row0, col0, w_loc)``.  ``x_ext`` and
    ``images`` are ``(h_loc, w_loc + 2 HALO_COLS)`` lane-extended blocks,
    the six ``halos`` ``(R, w_loc + 2 HALO_COLS)`` with ``R >= reach_r``,
    ``atb_ext`` ``(h_loc + 2R, w_loc + 2 HALO_COLS)``; ``off = (row, col)``,
    the global position of the extended block's (0, 0); the core must lie
    in the ``(H_global, W_global)`` image."""
    C = HALO_COLS
    if reach_c > C:
        raise ValueError(f"{C} halo columns: this kernel reads {reach_c} columns from each neighbour")
    _check_image(x_ext, "x_ext")
    h_loc, w_ext = x_ext.shape
    w_loc = w_ext - 2 * C
    if w_loc < 1:
        raise ValueError(f"x_ext: {w_ext} columns, need the core and {C} halo columns each side")
    R, row0 = check_shard(x_ext, images, halos, 6, int(off[0]), H_global, reach_r)
    _check_image(atb_ext, "atb_ext")
    if tuple(atb_ext.shape) != (h_loc + 2 * R, w_ext) or atb_ext.device != x_ext.device:
        raise ValueError(f"atb_ext: {tuple(atb_ext.shape)} on {atb_ext.device}, expected "
                         f"{(h_loc + 2 * R, w_ext)} on {x_ext.device}")
    col0 = int(off[1]) + C
    if col0 < 0 or col0 + w_loc > W_global:
        raise ValueError(f"core columns [{col0}, {col0 + w_loc}) outside an image of {W_global} columns")
    return R, row0, col0, w_loc


def tv_pds_megar_shard2d_step_plain(x_ext, z0_ext, z1_ext, atb_ext, halos, fwd: SepFactors,
                                    adj2: SepFactors, off, *, H_global, W_global, **kw):
    """Plain PyTorch version of K17: K4's plain version on the
    ``(h_loc + 2R, w_loc + 2 HALO_COLS)`` block, cut to the image and grown
    by a zero row and column where it stops short of the image's last
    (``kernels.tv.shard_plain`` on both axes)."""
    xt, xb, z0t, z0b, z1t, z1b = halos
    ext = (torch.cat([xt, x_ext, xb]), torch.cat([z0t, z0_ext, z0b]), torch.cat([z1t, z1_ext, z1b]), atb_ext)
    w_loc = x_ext.shape[1] - 2 * HALO_COLS
    return shard_plain(lambda *a: tv_pds_megar_step_plain(*a, fwd, adj2, **kw), ext, int(off[0]),
                       x_ext.shape[0], H_global, cols=(int(off[1]), w_loc, W_global))


def tv_pds_megar_shard2d_step(x_ext, z0_ext, z1_ext, atb_ext, halos, fwd: SepFactors, adj2: SepFactors,
                              off, *, H_global, W_global, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K17: K4 on the core of a block of a 2-D ``(sp0, sp1)`` mesh.
    ``x_ext``/``z0_ext``/``z1_ext``: the block's ``(h_loc, w_loc + 64)``
    lane-extended rows (``parallel.lane_extend`` with ``HALO_COLS`` = 32,
    zeros beyond the image); ``atb_ext``: the ``(h_loc + 2R, w_loc + 64)``
    fully extended atb; ``halos = (xt, xb, z0t, z0b, z1t, z1b)``: ``(R,
    w_loc + 64)`` rows of the row neighbours' lane-extended blocks (the
    diagonal corners ride along), R >= the PSF's rows; ``off``: the global
    ``(row, col)`` of the extended block's (0, 0), ``(row0 - R, col0 -
    32)``; ``H_global``/``W_global``: the image's.  Returns ``(x', z0',
    z1', stats (6,))`` of the ``(h_loc, w_loc)`` core in new buffers.

    Replaces ``pycsou_tpu/kernels/tvr.py`` ``tv_pds_megar_shard2d_step``
    (``_tv_megar_kernel`` with ``CORE_L = 128`` via ``_megar_call``).
    Bound by device memory: K4's 7 streams over the core and its halos;
    each block recomputes the Gram of its tile from the halos."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    R, row0, col0, w_loc = check_shard2d(x_ext, dict(z0_ext=z0_ext, z1_ext=z1_ext), halos, off, H_global,
                                         W_global, fwd.Ku, fwd.Kv, atb_ext)
    taps = gram_taps(fwd, adj2)
    _check_device(x_ext, fwd, adj2)
    if x_ext.device.type == "cpu":
        return tv_pds_megar_shard2d_step_plain(x_ext, z0_ext, z1_ext, atb_ext, halos, fwd, adj2, off,
                                               H_global=H_global, W_global=W_global, **kw)
    h_loc = x_ext.shape[0]
    xo, z0o, z1o = (x_ext.new_empty((h_loc, w_loc)) for _ in range(3))
    nblocks = -(-h_loc // TILE) * -(-w_loc // TILE)
    partials = x_ext.new_empty(nblocks * 6)
    stats = x_ext.new_empty(6)
    launch(
        "pct_tv_megar_shard2d", "tv_pds_megar_shard2d_step", x_ext,
        x_ext.data_ptr(), z0_ext.data_ptr(), z1_ext.data_ptr(), atb_ext.data_ptr(),
        *(t.data_ptr() for t in halos), xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(),
        partials.data_ptr(), stats.data_ptr(), row0, h_loc, R, col0, w_loc, HALO_COLS, H_global, W_global,
        taps.ctypes.data, fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov, 2.0,
        float(tau), float(sigma), float(rho), float(lam), int(bool(nonneg)), int(bool(iso)),
    )
    tv_pds_megar_shard2d_step.launches += 1
    return xo, z0o, z1o, stats


tv_pds_megar_shard2d_step.launches = 0
