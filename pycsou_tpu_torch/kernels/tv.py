"""TV primal-dual stencil steps: from a given gradient (K3), masked (K5) and
masked two steps at a time (K6); their plain versions and the stencil twin.

One Condat-Vu iteration of TV-regularised deconvolution, given the data
gradient g::

    x_t = P(x - tau g - tau div z)       P = max(., 0) when nonneg
    u   = 2 x_t - x
    v   = z + sigma grad u
    z_t = v lam / max(|v|_2, lam)        per pixel (isotropic), or the
                                         [-lam, lam] clip (anisotropic)
    x'  = rho x_t + (1 - rho) x,  z' = rho z_t + (1 - rho) z

Boundary conventions are those of ``ops/diff.py``: forward differences
with a zero last row/column, divergence ``(D^T y)_j = y_{j-1} - y_j``; the
last row of z0 and the last column of z1 are read as 0 and come out 0.

:func:`tv_pds_stencil_step_plain` is the twin of the reference's
``tv_pds_stencil_step_xla`` and the specification of the stencil; the
kernel's plain version adds the dual masks and the stopping-metric partial
sums ``[|dx|^2, |x|^2, |dz0|^2, |z0|^2, |dz1|^2, |z1|^2]``.

The masked steps take a diagonal Gram ``m`` (a sampling operator's
``A^H 1``) and ``atb = A^H y`` in place of g, which they form in the
kernel as ``g = 2 (m x - atb)``.
"""
from __future__ import annotations

import torch

from pycsou_tpu_torch.kernels._build import TILE, check, library, stream_of
from pycsou_tpu_torch.kernels.conv2d import _check_device, _check_image
from pycsou_tpu_torch.ops.diff import fdiff_forward, fdiff_forward_adjoint

__all__ = [
    "tv_pds_stencil_step_plain",
    "tv_pds_sweep_step_stats",
    "tv_pds_sweep_step_stats_plain",
    "tv_pds_stencil_step_sweep",
    "stats_of",
    "tv_pds_sweepm_step_stats",
    "tv_pds_sweepm_step_stats_plain",
    "tv_pds_sweepm2_step",
    "tv_pds_sweepm2_step_plain",
]


def tv_pds_stencil_step_plain(x, z, g, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """Plain twin of ``pycsou_tpu/kernels/tv.py`` ``tv_pds_stencil_step_xla``
    (stacked dual ``z`` of shape (2, H, W))."""
    div = fdiff_forward_adjoint(z[0], 0) + fdiff_forward_adjoint(z[1], 1)
    x_t = x - tau * g - tau * div
    if nonneg:
        x_t = torch.clamp(x_t, min=0.0)
    u = 2.0 * x_t - x
    v = z + sigma * torch.stack([fdiff_forward(u, 0), fdiff_forward(u, 1)], dim=0)
    if iso:
        mag = torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))
        z_t = v * (lam / torch.clamp(mag, min=lam))
    else:
        z_t = torch.clamp(v, -lam, lam)
    return rho * x_t + (1.0 - rho) * x, rho * z_t + (1.0 - rho) * z


def _mask_duals(z0, z1):
    """The dual invariant: last row of z0 and last column of z1 read as 0."""
    z0 = z0.clone()
    z0[-1] = 0.0
    z1 = z1.clone()
    z1[:, -1] = 0.0
    return z0, z1


def stats_of(pairs) -> torch.Tensor:
    """(6,) partial sums ``sum (new - old)^2, sum old^2`` for each
    ``(new, old)`` pair in (x, z0, z1) order."""
    vals = []
    for new, old in pairs:
        d = new - old
        vals += [torch.sum(d * d), torch.sum(old * old)]
    return torch.stack(vals).to(torch.float32)


def tv_pds_sweep_step_stats_plain(x, z0, z1, g, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """Plain PyTorch version of K3: ``(x', z0', z1', stats)``."""
    z0, z1 = _mask_duals(z0, z1)
    xn, zn = tv_pds_stencil_step_plain(
        x, torch.stack([z0, z1]), g, tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso
    )
    return xn, zn[0], zn[1], stats_of([(xn, x), (zn[0], z0), (zn[1], z1)])


def tv_pds_sweep_step_stats(x, z0, z1, g, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K3: one stencil step from the gradient g, with the metric partial
    sums; returns ``(x', z0', z1', stats (6,))`` in new buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_sweep_step_stats``
    (``_tv_sweep_kernel`` via ``_sweep_call``).  Bound by device memory: 7
    image streams.  The outputs never alias the inputs (neighbouring blocks
    read x and z; the TPU's in-place update relied on an ordered grid)."""
    for name, t in (("x", x), ("z0", z0), ("z1", z1), ("g", g)):
        _check_image(t, name, like=None if name == "x" else x)
    _check_device(x)
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    if x.device.type == "cpu":
        return tv_pds_sweep_step_stats_plain(x, z0, z1, g, **kw)
    H, W = x.shape
    xo, z0o, z1o = (torch.empty_like(x) for _ in range(3))
    nblocks = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=x.device)
    stats = torch.empty(6, dtype=torch.float32, device=x.device)
    err = library().pct_tv_sweep_stats(
        x.data_ptr(), z0.data_ptr(), z1.data_ptr(), g.data_ptr(),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        H, W, float(tau), float(sigma), float(rho), float(lam), int(bool(nonneg)), int(bool(iso)),
        stream_of(x),
    )
    check(err, "tv_pds_sweep_step_stats")
    tv_pds_sweep_step_stats.launches += 1
    return xo, z0o, z1o, stats


tv_pds_sweep_step_stats.launches = 0


def tv_pds_stencil_step_sweep(x, z, g, **kw):
    """Stacked-dual form of K3 (``pycsou_tpu``'s
    ``tv_pds_stencil_step_sweep``): ``(x', z' (2, H, W))``."""
    xn, z0n, z1n, _ = tv_pds_sweep_step_stats(x, z[0].contiguous(), z[1].contiguous(), g, **kw)
    return xn, torch.stack([z0n, z1n])


# -- the masked (diagonal-Gram) steps: g = 2 (m x - atb) ---------------------


def tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, *, tau, sigma, rho, lam, nonneg=True,
                                   iso=True):
    """Plain PyTorch version of K5: the gradient of the diagonal Gram,
    ``2 (m x - atb)``, then K3's plain version."""
    return tv_pds_sweep_step_stats_plain(
        x, z0, z1, 2.0 * (m * x - atb), tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg,
        iso=iso,
    )


def tv_pds_sweepm2_step_plain(x, z0, z1, m, atb, **kw):
    """Plain PyTorch version of K6: two plain K5 steps; the stats compare
    the second step's output with the first's."""
    x, z0, z1, _ = tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw)
    return tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw)


def _check_masked(x, z0, z1, m, atb) -> None:
    for name, t in (("x", x), ("z0", z0), ("z1", z1), ("m", m), ("atb", atb)):
        _check_image(t, name, like=None if name == "x" else x)
    _check_device(x)


def _launch_masked(fn, symbol, x, z0, z1, m, atb, kw):
    """Launch of K5 or K6 (same C signature); counts on ``fn``."""
    H, W = x.shape
    xo, z0o, z1o = (torch.empty_like(x) for _ in range(3))
    nblocks = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=x.device)
    stats = torch.empty(6, dtype=torch.float32, device=x.device)
    err = getattr(library(), symbol)(
        x.data_ptr(), z0.data_ptr(), z1.data_ptr(), m.data_ptr(), atb.data_ptr(),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        H, W, float(kw["tau"]), float(kw["sigma"]), float(kw["rho"]), float(kw["lam"]),
        int(bool(kw["nonneg"])), int(bool(kw["iso"])), stream_of(x),
    )
    check(err, fn.__name__)
    fn.launches += 1
    return xo, z0o, z1o, stats


def tv_pds_sweepm_step_stats(x, z0, z1, m, atb, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K5: one masked TV PDS iteration, the gradient ``2 (m x - atb)``
    computed in the kernel from the m and atb streams; returns ``(x', z0',
    z1', stats (6,))`` in new buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_sweepm_step_stats``
    (``_tv_sweepm_kernel``).  Bound by device memory: 8 image streams (x,
    m, atb, z0, z1 in; x', z0', z1' out)."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _check_masked(x, z0, z1, m, atb)
    if x.device.type == "cpu":
        return tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw)
    return _launch_masked(tv_pds_sweepm_step_stats, "pct_tv_sweepm_stats", x, z0, z1, m, atb, kw)


tv_pds_sweepm_step_stats.launches = 0


def tv_pds_sweepm2_step(x, z0, z1, m, atb, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K6: two masked TV PDS iterations in one pass; returns the state after
    both and the stats of the second only, ``(x'', z0'', z1'', stats (6,))``,
    in new buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_sweepm2_step``
    (``_tv_sweepm2_kernel``).  Bound by device memory: K5's 8 image streams
    serve two iterations (each block reads its inputs over its tile grown by
    2 and keeps the first iteration in shared memory)."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _check_masked(x, z0, z1, m, atb)
    if x.device.type == "cpu":
        return tv_pds_sweepm2_step_plain(x, z0, z1, m, atb, **kw)
    return _launch_masked(tv_pds_sweepm2_step, "pct_tv_sweepm2", x, z0, z1, m, atb, kw)


tv_pds_sweepm2_step.launches = 0
