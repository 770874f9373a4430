"""TV primal-dual stencil steps: from a given gradient (K3, and K13 on a
stacked dual), masked (K5), masked two steps at a time (K6), and the rank-1
engines with the Gram in the kernel (K10 two steps, K11 one step, K12 the
row Gram of a given w), and K3 and K11 on a row shard of the image (K16,
K14); their plain versions and the stencil twin.

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

The rank-1 engines take ``atb`` and a rank-1
:class:`~pycsou_tpu_torch.ops.conv.SeparableConvGram2D` (its ``g_meta``
plan) and form ``g = 2 (RowGram(ColGram(x)) - atb)`` in the kernel, each
direction one band pass of the autocorrelation plus the edge corrections
(``kernels/band.py``).  Their kernels are instantiated for padded reaches
``R1_REACHES``: a PSF of at most 16 taps on each axis.

The shard kernels run one iteration on a shard's core rows ``[row0, row0 +
h_loc)`` of an image of ``H_global`` rows.  They take the core blocks, the
``(R, W)`` halo blocks of the neighbouring shards above and below (zeros
beyond the image's edges) and ``off = row0 - R``, the global row of the
halo-extended block's first row, as the reference's do; the outputs are the
core's, in new buffers, with the core's partial sums.  Every boundary keys
to global rows.  Their plain versions run the single-device plain engine on
the halo-extended block (:func:`shard_plain`).
"""
from __future__ import annotations

import torch

import numpy as np

from pycsou_tpu_torch.kernels._build import TILE, check, library, stream_of
from pycsou_tpu_torch.kernels.band import gram_band_cols, gram_band_rows
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
    "R1_REACHES",
    "rank1_reach",
    "tv_pds_stencil_step",
    "tv_pds_mega_step",
    "tv_pds_mega_step_plain",
    "tv_pds_mega2_step",
    "tv_pds_mega2_step_plain",
    "tv_pds_mega3_step",
    "tv_pds_mega3_step_plain",
    "shard_plain",
    "tv_pds_sweep_shard_step",
    "tv_pds_sweep_shard_step_plain",
    "tv_pds_mega2_shard_step",
    "tv_pds_mega2_shard_step_plain",
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
    serve two iterations (two blocks an SM walk 32 x 64 tiles, each read
    over the tile grown by 2, the first iteration kept in shared memory;
    the partial sums are one slot a block, fewer than ``_launch_masked``
    allocates)."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _check_masked(x, z0, z1, m, atb)
    if x.device.type == "cpu":
        return tv_pds_sweepm2_step_plain(x, z0, z1, m, atb, **kw)
    return _launch_masked(tv_pds_sweepm2_step, "pct_tv_sweepm2", x, z0, z1, m, atb, kw)


tv_pds_sweepm2_step.launches = 0


# -- K13: the stencil step on a stacked dual -----------------------------------


def _check_stacked(x, z) -> None:
    _check_image(x, "x")
    H, W = x.shape
    if z.dtype != torch.float32 or tuple(z.shape) != (2, H, W) or not z.is_contiguous() \
            or z.device != x.device:
        raise ValueError(f"z: need a contiguous float32 (2, {H}, {W}) tensor on {x.device}, got "
                         f"{z.dtype} {tuple(z.shape)} on {z.device}")


def tv_pds_stencil_step(x, z, g, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K13: one stencil step from the gradient g on a stacked dual ``z (2,
    H, W)``; returns ``(x', z' (2, H, W))`` in new buffers, no partial sums.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_stencil_step``
    (``_tv_kernel``, the Element-halo row blocks).  Bound by device memory:
    7 image streams (x, g, z (2) in; x', z' (2) out).  Its plain version is
    :func:`tv_pds_stencil_step_plain`."""
    _check_stacked(x, z)
    _check_image(g, "g", like=x)
    _check_device(x)
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    if x.device.type == "cpu":
        return tv_pds_stencil_step_plain(x, z, g, **kw)
    H, W = x.shape
    xo, zo = torch.empty_like(x), torch.empty_like(z)
    err = library().pct_tv_stencil(
        x.data_ptr(), z.data_ptr(), g.data_ptr(), xo.data_ptr(), zo.data_ptr(), H, W,
        float(tau), float(sigma), float(rho), float(lam), int(bool(nonneg)), int(bool(iso)),
        stream_of(x),
    )
    check(err, "tv_pds_stencil_step")
    tv_pds_stencil_step.launches += 1
    return xo, zo


tv_pds_stencil_step.launches = 0


# -- the rank-1 engines (K10-K12) -----------------------------------------------

R1_REACHES = (0, 4, 8, 15)  # padded reaches the kernels are instantiated for (csrc/tvr1.cu)
_R1_MAX = 2 * R1_REACHES[-1] + 1  # taps per axis in the kernels' R1Taps


def rank1_reach(gram) -> int:
    """The padded reach R the rank-1 kernels take for ``gram`` (the PSF's
    larger reach, K - 1, rounded up to ``R1_REACHES``); raises when the
    Gram has no rank-1 plan or a reach beyond 15."""
    if getattr(gram, "g_meta", None) is None:
        raise ValueError("the rank-1 engines need a SeparableConvGram2D with the rank-1 plan "
                         "(a rank-1 PSF, H >= 3 m0 and W >= 3 m1)")
    reach = max(len(gram.g_rows_taps), len(gram.g_cols_taps)) - 1
    for R in R1_REACHES:
        if reach <= R:
            return R
    raise ValueError(f"the rank-1 kernels take at most {R1_REACHES[-1] + 1} taps per axis, "
                     f"the PSF has {len(gram.g_rows_taps)} x {len(gram.g_cols_taps)}")


def _rank1_args(gram):
    """``(taps, E, Kr, Kc, R)`` for the C launchers, built once per Gram:
    the two autocorrelations centred at R in one host array (the row band
    with the gradient's 2x), and the edge corrections on the device, the
    row ones with the 2x."""
    args = getattr(gram, "_r1_args", None)
    if args is None:
        R = rank1_reach(gram)
        Kr, Kc = len(gram.g_rows_taps), len(gram.g_cols_taps)
        taps = np.zeros(2 * _R1_MAX, np.float32)
        taps[R - (Kr - 1) : R + Kr] = 2.0 * np.asarray(gram.g_rows_acorr, np.float32)
        taps[_R1_MAX + R - (Kc - 1) : _R1_MAX + R + Kc] = np.asarray(gram.g_cols_acorr, np.float32)
        parts = [2.0 * e.reshape(-1) for e in (gram.g_rows_E or ())]
        parts += [e.reshape(-1) for e in (gram.g_cols_E or ())]
        E = torch.cat(parts) if parts else torch.zeros(1, device=gram.device)
        args = gram._r1_args = (taps, E.contiguous(), Kr, Kc, R)
    return args


def _rank1_grad_plain(x, atb, gram):
    """``2 (RowGram(ColGram(x)) - atb)`` by the plain band passes."""
    rows, cols = gram.band_plans()
    return 2.0 * (gram_band_rows(gram_band_cols(x, cols), rows) - atb)


def tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw):
    """Plain PyTorch version of K11: the rank-1 gradient by the plain band
    passes, then K3's plain version."""
    return tv_pds_sweep_step_stats_plain(x, z0, z1, _rank1_grad_plain(x, atb, gram), **kw)


def tv_pds_mega3_step_plain(x, z0, z1, atb, gram, **kw):
    """Plain PyTorch version of K10: two plain K11 steps; the stats compare
    the second step's output with the first's."""
    x, z0, z1, _ = tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw)
    return tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw)


def tv_pds_mega_step_plain(x, z, w, atb, gram, **kw):
    """Plain PyTorch version of K12: ``g = 2 (RowGram(w) - atb)``, then the
    plain stencil on the stacked dual."""
    rows, _ = gram.band_plans()
    return tv_pds_stencil_step_plain(x, z, 2.0 * (gram_band_rows(w, rows) - atb), **kw)


def _check_rank1_gram(gram, device, shape) -> None:
    rank1_reach(gram)
    acorr = gram.band_plans()[0][0]
    if acorr.device != device or tuple(gram.dim_shape) != tuple(shape):
        raise ValueError(f"gram on {acorr.device} for {tuple(gram.dim_shape)}, image {tuple(shape)} "
                         f"on {device}")


def _check_rank1(gram, x, **images) -> None:
    _check_image(x, "x")
    for name, t in images.items():
        _check_image(t, name, like=x)
    _check_device(x)
    _check_rank1_gram(gram, x.device, x.shape)


def _launch_rank1(fn, symbol, x, z0, z1, atb, gram, kw):
    """Launch of K10 or K11 (same C signature); counts on ``fn``."""
    taps, E, Kr, Kc, R = _rank1_args(gram)
    H, W = x.shape
    xo, z0o, z1o = (torch.empty_like(x) for _ in range(3))
    nblocks = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=x.device)
    stats = torch.empty(6, dtype=torch.float32, device=x.device)
    err = getattr(library(), symbol)(
        x.data_ptr(), z0.data_ptr(), z1.data_ptr(), atb.data_ptr(),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        H, W, taps.ctypes.data, E.data_ptr(), Kr, Kc, R,
        float(kw["tau"]), float(kw["sigma"]), float(kw["rho"]), float(kw["lam"]),
        int(bool(kw["nonneg"])), int(bool(kw["iso"])), stream_of(x),
    )
    check(err, fn.__name__)
    fn.launches += 1
    return xo, z0o, z1o, stats


def tv_pds_mega2_step(x, z0, z1, atb, gram, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K11: one TV PDS iteration for a rank-1 PSF with both Gram directions
    in the kernel; ``(x', z0', z1', stats (6,))`` in new buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_mega2_step``
    (``_tv_mega2_kernel``, ``_mega_row_gram``, ``_lane_gram_tile``).  Bound
    by device memory: 7 image streams.  Each block stages a 32 x 64 tile
    in shared memory (``csrc/tvr1.cu``): the x window by 16-byte
    ``cp.async`` where a row allows, then z0, z1 and atb, which arrive
    during the Gram's two band passes of 2K - 1 taps; then x_t once a
    pixel and the update.  No more blocks than the 32 x 32 tiles'
    partial sums this wrapper allocates."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _check_rank1(gram, x, z0=z0, z1=z1, atb=atb)
    if x.device.type == "cpu":
        return tv_pds_mega2_step_plain(x, z0, z1, atb, gram, **kw)
    return _launch_rank1(tv_pds_mega2_step, "pct_tv_mega2", x, z0, z1, atb, gram, kw)


tv_pds_mega2_step.launches = 0


def tv_pds_mega3_step(x, z0, z1, atb, gram, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K10: two TV PDS iterations for a rank-1 PSF in one pass; the state
    after both and the stats of the second only (its "old" is the first
    iteration's output), ``(x'', z0'', z1'', stats (6,))``, in new buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_mega3_step``
    (``_tv_mega3_kernel``).  Bound by device memory: K11's 7 image streams
    serve two iterations (each block walks a column strip down a segment of
    rows and keeps the first iteration in rings of rows in shared memory)."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _check_rank1(gram, x, z0=z0, z1=z1, atb=atb)
    if x.device.type == "cpu":
        return tv_pds_mega3_step_plain(x, z0, z1, atb, gram, **kw)
    return _launch_rank1(tv_pds_mega3_step, "pct_tv_mega3", x, z0, z1, atb, gram, kw)


tv_pds_mega3_step.launches = 0


def tv_pds_mega_step(x, z, w, atb, gram, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """K12: one TV PDS iteration from ``w = ColGram(x)`` (formed by the
    caller): the exact row Gram of w with its edge corrections, ``g = 2
    (RowGram(w) - atb)``, and the stencil on the stacked dual; ``(x', z' (2,
    H, W))`` in new buffers, no partial sums.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_mega_step``
    (``_tv_mega_kernel``).  Bound by device memory: 8 image streams (w, x,
    atb, z (2) in; x', z' (2) out), plus the caller's pass for w.  Each
    block stages a 32 x 64 tile as K11 does (``csrc/tvr1.cu``): the w
    window for the row band pass, then x, z's halves and atb, which
    arrive during that pass; then x_t once a pixel and the update."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _check_stacked(x, z)
    _check_rank1(gram, x, w=w, atb=atb)
    if x.device.type == "cpu":
        return tv_pds_mega_step_plain(x, z, w, atb, gram, **kw)
    taps, E, Kr, Kc, R = _rank1_args(gram)
    H, W = x.shape
    xo, zo = torch.empty_like(x), torch.empty_like(z)
    err = library().pct_tv_mega(
        x.data_ptr(), z.data_ptr(), w.data_ptr(), atb.data_ptr(), xo.data_ptr(), zo.data_ptr(),
        H, W, taps.ctypes.data, E.data_ptr(), Kr, Kc, R,
        float(tau), float(sigma), float(rho), float(lam), int(bool(nonneg)), int(bool(iso)),
        stream_of(x),
    )
    check(err, "tv_pds_mega_step")
    tv_pds_mega_step.launches += 1
    return xo, zo


tv_pds_mega_step.launches = 0


# -- the row-shard kernels (K16, K14) -------------------------------------------


def _onto_image(ext, axis: int, off: int, n_core: int, n_global: int):
    """``ext`` cut along ``axis`` to the image (indices ``[off, off + n)``
    of ``n_global``), with a zero slice added where it stops short of the
    image's last one; returns it and the core's slice there."""
    n = ext[0].shape[axis]
    R = (n - n_core) // 2
    lo, hi = max(0, -off), min(n, n_global - off)
    ext = [t.narrow(axis, lo, hi - lo) for t in ext]
    if off + n < n_global:
        ext = [torch.cat([t, t.new_zeros(t.shape[:axis] + (1,) + t.shape[axis + 1:])], dim=axis) for t in ext]
    return ext, slice(R - lo, R - lo + n_core)


def shard_plain(engine, ext, off: int, h_loc: int, H_global: int, cols=None):
    """A single-device plain engine on a halo-extended row shard: ``ext =
    (x, z0, z1, a)``, rows ``[off, off + h_loc + 2R)`` of an image of
    ``H_global`` rows (``a`` the engine's fourth input, atb or g).  Rows
    outside the image are dropped, and a zero row is added below when the
    block stops short of the image's last row, so that the engine's last-row
    rules (the dual mask, the zero forward difference) and its image-edge
    corrections fall on rows the core does not read (given R covers the
    engine's reach).  ``cols = (col_off, w_loc, W_global)`` does the same
    along the columns, for a block of a 2-D mesh extended by C columns each
    side.  Returns the core of ``engine(*ext)``'s (x', z0', z1') and the
    core's partial sums."""
    ext, rows = _onto_image(ext, 0, off, h_loc, H_global)
    core = (rows, slice(None))
    if cols is not None:
        ext, core_cols = _onto_image(ext, 1, *cols)
        core = (rows, core_cols)
    xn, z0n, z1n, _ = engine(*ext)
    z0, z1 = _mask_duals(ext[1], ext[2])  # the old duals as the stats read them
    xn, z0n, z1n = (t[core].contiguous() for t in (xn, z0n, z1n))
    return xn, z0n, z1n, stats_of([(xn, ext[0][core]), (z0n, z0[core]), (z1n, z1[core])])


def _ext(top, core, bot):
    return torch.cat([top, core, bot])


def check_shard(x, images, halos, n_halos: int, off: int, H_global: int, reach: int, atb_ext=None):
    """Checks shared by the shard kernels; returns ``(R, row0)``.  ``reach``:
    the halo rows the kernel reads from each neighbour; ``atb_ext``, where
    given, must be the (h_loc + 2R, W) halo-extended block."""
    _check_image(x, "x")
    for name, t in images.items():
        _check_image(t, name, like=x)
    _check_device(x)
    if len(halos) != n_halos:
        raise ValueError(f"need {n_halos} halo blocks, got {len(halos)}")
    R, W = halos[0].shape
    for i, t in enumerate(halos):
        _check_image(t, f"halos[{i}]")
        if tuple(t.shape) != (R, W) or W != x.shape[1] or t.device != x.device:
            raise ValueError(f"halos[{i}]: {tuple(t.shape)} on {t.device}, expected ({R}, {x.shape[1]}) "
                             f"on {x.device}")
    if R < reach:
        raise ValueError(f"{R} halo rows: this kernel reads {reach} rows from each neighbour")
    row0, h_loc = int(off) + R, x.shape[0]
    if atb_ext is not None:
        _check_image(atb_ext, "atb_ext")
        if tuple(atb_ext.shape) != (h_loc + 2 * R, W) or atb_ext.device != x.device:
            raise ValueError(f"atb_ext: {tuple(atb_ext.shape)} on {atb_ext.device}, expected "
                             f"{(h_loc + 2 * R, W)} on {x.device}")
    if row0 < 0 or row0 + h_loc > H_global:
        raise ValueError(f"core rows [{row0}, {row0 + h_loc}) outside an image of {H_global} rows")
    return R, row0


def _launch_shard(fn, symbol, x, core, halos, row0, H_global, args, kw):
    """Launch of a shard kernel (core blocks, halos, outputs, then
    ``(row0, h_loc, R, H, W)`` and ``args``); counts on ``fn``."""
    h_loc, W = x.shape
    xo, z0o, z1o = (torch.empty_like(x) for _ in range(3))
    nblocks = -(-h_loc // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=x.device)
    stats = torch.empty(6, dtype=torch.float32, device=x.device)
    err = getattr(library(), symbol)(
        *(t.data_ptr() for t in core), *(t.data_ptr() for t in halos),
        xo.data_ptr(), z0o.data_ptr(), z1o.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        row0, h_loc, halos[0].shape[0], H_global, W, *args,
        float(kw["tau"]), float(kw["sigma"]), float(kw["rho"]), float(kw["lam"]),
        int(bool(kw["nonneg"])), int(bool(kw["iso"])), stream_of(x),
    )
    check(err, fn.__name__)
    fn.launches += 1
    return xo, z0o, z1o, stats


def tv_pds_sweep_shard_step_plain(x, g, z0, z1, halos, off, *, H_global, **kw):
    """Plain PyTorch version of K16: K3's plain version on the
    halo-extended shard (:func:`shard_plain`)."""
    xt, xb, gt, gb, z0t, z0b, z1t, z1b = halos
    ext = (_ext(xt, x, xb), _ext(z0t, z0, z0b), _ext(z1t, z1, z1b), _ext(gt, g, gb))
    return shard_plain(lambda *a: tv_pds_sweep_step_stats_plain(*a, **kw), ext, off, x.shape[0], H_global)


def tv_pds_sweep_shard_step(x, g, z0, z1, halos, off, *, H_global, tau, sigma, rho, lam, nonneg=True,
                            iso=True):
    """K16: K3 on the core rows of a row shard, given the gradient g;
    ``halos = (xt, xb, gt, gb, z0t, z0b, z1t, z1b)``, (R, W) blocks with R
    >= 1; ``(x', z0', z1', stats (6,))`` of the core in new buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_sweep_shard_step``
    (``_tv_sweep_kernel`` in shard mode via ``_sweep_call``).  Bound by
    device memory: K3's 7 core streams and one halo row of x, g, z0 and z1
    from each neighbour."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _, row0 = check_shard(x, dict(g=g, z0=z0, z1=z1), halos, 8, off, H_global, 1)
    if x.device.type == "cpu":
        return tv_pds_sweep_shard_step_plain(x, g, z0, z1, halos, off, H_global=H_global, **kw)
    return _launch_shard(tv_pds_sweep_shard_step, "pct_tv_sweep_shard", x, (x, z0, z1, g), halos, row0,
                         H_global, (), kw)


tv_pds_sweep_shard_step.launches = 0


def tv_pds_mega2_shard_step_plain(x, z0, z1, atb_ext, halos, gram, off, *, H_global, **kw):
    """Plain PyTorch version of K14: K11's plain version on the
    halo-extended shard (:func:`shard_plain`)."""
    xt, xb, z0t, z0b, z1t, z1b = halos
    ext = (_ext(xt, x, xb), _ext(z0t, z0, z0b), _ext(z1t, z1, z1b), atb_ext)
    return shard_plain(lambda *a: tv_pds_mega2_step_plain(*a, gram, **kw), ext, off, x.shape[0], H_global)


def tv_pds_mega2_shard_step(x, z0, z1, atb_ext, halos, gram, off, *, H_global, tau, sigma, rho, lam,
                            nonneg=True, iso=True):
    """K14: K11 on the core rows of a row shard; ``halos = (xt, xb, z0t,
    z0b, z1t, z1b)``, (R, W) blocks with R >= the padded reach + 1 (16 for
    a PSF of 16 rows), ``atb_ext`` the (h_loc + 2R, W) halo-extended atb,
    ``gram`` the rank-1 Gram of the whole (H_global, W) image on the
    shard's device; ``(x', z0', z1', stats (6,))`` of the core in new
    buffers.

    Replaces ``pycsou_tpu/kernels/tv.py`` ``tv_pds_mega2_shard_step``
    (``_tv_mega2_kernel`` in shard mode via ``_mega2_call``).  Bound by
    device memory: K11's 7 streams over the core and its halos."""
    kw = dict(tau=tau, sigma=sigma, rho=rho, lam=lam, nonneg=nonneg, iso=iso)
    _, row0 = check_shard(x, dict(z0=z0, z1=z1), halos, 6, off, H_global, rank1_reach(gram) + 1, atb_ext)
    _check_rank1_gram(gram, x.device, (H_global, x.shape[1]))
    if x.device.type == "cpu":
        return tv_pds_mega2_shard_step_plain(x, z0, z1, atb_ext, halos, gram, off, H_global=H_global, **kw)
    taps, E, Kr, Kc, Rp = _rank1_args(gram)
    return _launch_shard(tv_pds_mega2_shard_step, "pct_tv_mega2_shard", x, (x, z0, z1, atb_ext), halos,
                         row0, H_global, (taps.ctypes.data, E.data_ptr(), Kr, Kc, Rp), kw)


tv_pds_mega2_shard_step.launches = 0
