"""Halo exchange between the blocks of a sharded image (counterpart of
``pycsou_tpu/parallel/spatial.py`` ``halo_from_prev``/``halo_from_next`` and
``halo_from_prev_cols``/``halo_from_next_cols``).

A row-sharded image is a sequence of ``(h_loc, W)`` blocks in mesh order,
each on its mesh position's device.  Where the reference's ``ppermute``
sends rows to the neighbouring device, here each block receives them:
a neighbour's rows on the same device are a view of its block (a row slice
of a contiguous block is contiguous), on another device a copy
(``.to(device, non_blocking=True)``; right on a card of several GPUs, not
measured).  Rows beyond the image's first and last rows are zeros, the
zero boundary of the Gram and of the finite differences; such a block is
made once for each shape, dtype and device and then shared, so a caller
must not write into a halo.

A 2-D mesh ``(n0, n1)`` cuts the image into a grid of ``(h_loc, w_loc)``
blocks, a tuple of ``n0`` row tuples of ``n1`` blocks in mesh order (rows
over ``sp0``, columns over ``sp1``).  The column halos mirror the row
halos; a column slice of a block is not contiguous, so they are copies.
:func:`lane_extend` grows each block by ``C`` columns of its left and right
neighbours (the reference solver's ``_lane_ext_local``), and
:func:`halos_2d` takes the row halos from the neighbours' lane-extended
blocks, so that the diagonal corners ride along
(``Spatial2DTVDeconv2D._row_halos_local``).

On these sit the reference's sharded operators, each taking the blocks of
every mesh position in mesh order and returning a tuple of the results
(``sharded_*`` of a 1-D mesh on a sequence of row blocks, ``*_2d`` on a
grid): the finite differences and their adjoints (one halo row or
column), the overlap-save FFT convolution, its adjoint and the fused FFT
Gram (``m0 - 1`` halo rows, the frame corrections on the first and last
blocks), the band Gram of a rank-1 PSF (``kernels/band.py``: ``K - 1``
halo rows, the edge corrections on the first and last blocks; on a 2-D
mesh also along the columns) and the separable band convolution of a 2-D
mesh; :func:`pdot` and :func:`pnorm` add the blocks' sums on the first
block's device (the reference's ``psum``), and across processes too when
given a mesh that spans them.  A filter, transfer or plan is
given once, or for a transfer as a dict of one copy a device: where a
block lives on another device, a lone copy is copied there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import functools

import torch

from pycsou_tpu_torch.kernels.band import band_conv, gram_band_cols
from pycsou_tpu_torch.ops._gram import conv_full_direct
from pycsou_tpu_torch.ops.conv import next_fast_len
from pycsou_tpu_torch.ops.diff import fdiff_forward, fdiff_forward_adjoint
from pycsou_tpu_torch.parallel.mesh import Mesh, psum
from pycsou_tpu_torch.utils.device import full_f32

__all__ = [
    "halo_from_prev",
    "halo_from_next",
    "halo_extend",
    "halos",
    "halo_from_prev_cols",
    "halo_from_next_cols",
    "lane_extend",
    "halos_2d",
    "halo_extend_2d",
    "sharded_fdiff_rows",
    "sharded_fdiff_rows_adjoint",
    "sharded_grad2d",
    "sharded_grad2d_adjoint",
    "conv_transfer",
    "sharded_conv2d",
    "sharded_conv2d_adjoint",
    "sharded_conv2d_gram",
    "sharded_sepgram_rank1",
    "sharded_fdiff_cols",
    "sharded_fdiff_cols_adjoint",
    "sharded_grad2d_2d",
    "sharded_grad2d_adjoint_2d",
    "sharded_sepconv2d_2d",
    "sharded_sepconv2d_adjoint_2d",
    "sharded_sepgram_rank1_2d",
    "pdot",
    "pnorm",
]


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def _at(v, device: torch.device) -> torch.Tensor:
    """``v`` on ``device``: a dict holds one copy a device (a transfer made
    once for each), a tensor is copied there when it lives elsewhere."""
    return v[device] if isinstance(v, dict) else _on(v, device)


@functools.lru_cache(maxsize=64)
def _zero_block(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _zeros(block: torch.Tensor, h: int) -> torch.Tensor:
    return _zero_block((h,) + tuple(block.shape[1:]), block.dtype, block.device)


def _check(blocks: Sequence[torch.Tensor], h: int) -> None:
    if h < 0 or any(h > b.shape[0] for b in blocks):
        raise ValueError(f"{h} halo rows from blocks of {[b.shape[0] for b in blocks]} rows")


def halo_from_prev(blocks: Sequence[torch.Tensor], h: int) -> List[torch.Tensor]:
    """For each block, the last ``h`` rows of the previous block, on its own
    device (zeros for the first block)."""
    _check(blocks, h)
    return [_zeros(b, h) if i == 0 else _on(blocks[i - 1][blocks[i - 1].shape[0] - h:], b.device)
            for i, b in enumerate(blocks)]


def halo_from_next(blocks: Sequence[torch.Tensor], h: int) -> List[torch.Tensor]:
    """For each block, the first ``h`` rows of the next block, on its own
    device (zeros for the last block)."""
    _check(blocks, h)
    n = len(blocks)
    return [_zeros(b, h) if i == n - 1 else _on(blocks[i + 1][:h], b.device) for i, b in enumerate(blocks)]


def halo_extend(blocks: Sequence[torch.Tensor], h: int) -> List[torch.Tensor]:
    """Each block with ``h`` rows of its neighbours above and below, ``(h_loc
    + 2h, W)`` (the reference solver's ``_make_ext``)."""
    return [torch.cat([t, b, d]) for t, b, d in zip(halo_from_prev(blocks, h), blocks, halo_from_next(blocks, h))]


def halos(arrays: Sequence[Sequence[torch.Tensor]], h: int) -> List[tuple]:
    """For each shard, the ``h`` rows above and below it of each row-sharded
    array in ``arrays``, interleaved as the shard kernels take them:
    ``(a_top, a_bot, b_top, b_bot, ...)``."""
    per = [(halo_from_prev(a, h), halo_from_next(a, h)) for a in arrays]
    return [tuple(t for top, bot in per for t in (top[i], bot[i])) for i in range(len(arrays[0]))]


# -- the 2-D mesh: column halos and the grid of blocks ------------------------------


def _check_cols(blocks: Sequence[torch.Tensor], c: int) -> None:
    if c < 0 or any(c > b.shape[1] for b in blocks):
        raise ValueError(f"{c} halo columns from blocks of {[b.shape[1] for b in blocks]} columns")


def _col_zeros(block: torch.Tensor, c: int) -> torch.Tensor:
    return _zero_block((block.shape[0], c), block.dtype, block.device)


def _col_halos(blocks: Sequence[torch.Tensor], c: int):
    """For each block of a mesh row (left to right), the last ``c`` columns
    of its left neighbour and the first ``c`` of its right one on its own
    device (zeros beyond the image): views on the neighbour's device,
    copies on another."""
    _check_cols(blocks, c)
    n = len(blocks)

    def cols(j, lo, device):
        part = blocks[j][:, lo : lo + c]
        return part if blocks[j].device == device else _on(part.contiguous(), device)

    left = [_col_zeros(b, c) if j == 0 else cols(j - 1, blocks[j - 1].shape[1] - c, b.device)
            for j, b in enumerate(blocks)]
    right = [_col_zeros(b, c) if j == n - 1 else cols(j + 1, 0, b.device) for j, b in enumerate(blocks)]
    return left, right


def halo_from_prev_cols(blocks: Sequence[torch.Tensor], c: int) -> List[torch.Tensor]:
    """For each block of a mesh row (left to right), the last ``c`` columns
    of its left neighbour, contiguous, on its own device (zeros for the
    first)."""
    return [t.contiguous() for t in _col_halos(blocks, c)[0]]


def halo_from_next_cols(blocks: Sequence[torch.Tensor], c: int) -> List[torch.Tensor]:
    """For each block of a mesh row, the first ``c`` columns of its right
    neighbour, contiguous, on its own device (zeros for the last)."""
    return [t.contiguous() for t in _col_halos(blocks, c)[1]]


def lane_extend(grid: Sequence[Sequence[torch.Tensor]], c: int) -> tuple:
    """Each block of the grid with ``c`` columns of its left and right
    neighbours, ``(h_loc, w_loc + 2c)``, zeros beyond the image (one copy a
    block)."""
    out = []
    for row in grid:
        left, right = _col_halos(row, c)
        out.append(tuple(torch.cat([a, b, d], dim=1) for a, b, d in zip(left, row, right)))
    return tuple(out)


def _columns(grid):
    """The mesh columns of a grid: each a row-sharded sequence of blocks."""
    return [[row[j] for row in grid] for j in range(len(grid[0]))]


def halos_2d(grids: Sequence[Sequence[Sequence[torch.Tensor]]], h: int) -> tuple:
    """For each block of the grids (lane-extended by :func:`lane_extend`),
    the ``h`` rows above and below it of each grid, interleaved as
    :func:`halos` gives them, as a grid of tuples.  Taken from the
    lane-extended blocks of the row neighbours, they hold the diagonal
    neighbours' corner columns."""
    cols = [_columns(g) for g in grids]
    per_col = [halos([c[j] for c in cols], h) for j in range(len(cols[0]))]
    return tuple(tuple(pc[i] for pc in per_col) for i in range(len(grids[0])))


def halo_extend_2d(grid: Sequence[Sequence[torch.Tensor]], h: int, c: int) -> tuple:
    """Each block with ``h`` rows and ``c`` columns of its neighbours (the
    corners from its diagonal neighbours), ``(h_loc + 2h, w_loc + 2c)``,
    zeros beyond the image."""
    cols = [halo_extend(col, h) for col in _columns(lane_extend(grid, c))]
    return tuple(tuple(col[i] for col in cols) for i in range(len(grid)))


def _grid_of_columns(cols) -> tuple:
    """The grid whose mesh columns are ``cols`` (the inverse of
    :func:`_columns`)."""
    return tuple(tuple(col[i] for col in cols) for i in range(len(cols[0])))


def _extend(blocks: Sequence[torch.Tensor], lo: int, hi: int) -> List[torch.Tensor]:
    """Each block with ``lo`` rows of the previous block above and ``hi`` of
    the next below (zeros beyond the image)."""
    tops, bots = halo_from_prev(blocks, lo), halo_from_next(blocks, hi)
    return [torch.cat([t, b, d]) if lo or hi else b for t, b, d in zip(tops, blocks, bots)]


def _extend_cols(row: Sequence[torch.Tensor], lo: int, hi: int) -> List[torch.Tensor]:
    """Each block of a mesh row with ``lo`` columns of its left neighbour and
    ``hi`` of its right one (zeros beyond the image)."""
    lefts, rights = halo_from_prev_cols(row, lo), halo_from_next_cols(row, hi)
    return [torch.cat([a, b, d], dim=1) if lo or hi else b for a, b, d in zip(lefts, row, rights)]


# -- the 1-D mesh: row blocks --------------------------------------------------------


def sharded_fdiff_rows(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """The row-wise forward difference of a row-sharded image, globally
    ``ops.diff.fdiff_forward(x, 0)`` (last row of the image 0)."""
    out = []
    for i, (b, nxt) in enumerate(zip(blocks, halo_from_next(blocks, 1))):
        ext = torch.cat([b, nxt])
        d = (ext[1:] - ext[:-1]) / step
        if i == len(blocks) - 1:
            d[-1] = 0.0
        out.append(d)
    return tuple(out)


def sharded_fdiff_rows_adjoint(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """Its adjoint, ``(D^T y)_j = (y_{j-1} - y_j) / step`` with the image's
    last row of ``y`` taken as 0."""
    ys = list(blocks)
    ys[-1] = torch.cat([ys[-1][:-1], torch.zeros_like(ys[-1][-1:])])
    return tuple((ext[:-1] - ext[1:]) / step for ext in _extend(ys, 1, 0))


def sharded_grad2d(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """The (2, h, W) forward-difference gradient of each row block, globally
    ``ops.diff.Gradient``."""
    return tuple(torch.stack([d0, fdiff_forward(b, 1, step)])
                 for d0, b in zip(sharded_fdiff_rows(blocks, step), blocks))


def sharded_grad2d_adjoint(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """Its adjoint on (2, h, W) blocks."""
    rows = sharded_fdiff_rows_adjoint([g[0] for g in blocks], step)
    return tuple(r + fdiff_forward_adjoint(g[1], 1, step) for r, g in zip(rows, blocks))


def conv_transfer(filt: torch.Tensor, ext_shape) -> torch.Tensor:
    """The rFFT of ``filt`` on the grid that :func:`sharded_conv2d` uses for
    halo-extended blocks of ``ext_shape`` (computed once, not at every
    apply)."""
    (n0, n1), (m0, m1) = ext_shape, filt.shape
    return torch.fft.rfft2(filt, s=(next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1)))


def _local_conv_same(x: torch.Tensor, filt: torch.Tensor, o0: int, o1: int, h_hat=None) -> torch.Tensor:
    """The 'same'-size zero-boundary convolution of one (extended) block by
    FFT, the output's origin at ``(o0, o1)`` of the full convolution."""
    (n0, n1), (m0, m1) = x.shape, filt.shape
    s = (next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1))
    H = torch.fft.rfft2(filt, s=s) if h_hat is None else h_hat
    full = torch.fft.irfft2(torch.fft.rfft2(x, s=s) * H, s=s)
    return full[o0 : o0 + n0, o1 : o1 + n1]


def _os_conv(blocks, filt, o0: int, o1: int, h_hat=None) -> tuple:
    """Overlap-save: each block grown by ``m0 - 1 - o0`` rows of the
    previous block and ``o0`` of the next, convolved, cropped."""
    lo, hi = filt.shape[0] - 1 - o0, o0
    if any(max(lo, hi) > b.shape[0] for b in blocks):
        raise ValueError(f"blocks of {blocks[0].shape[0]} rows are shorter than the halo of {max(lo, hi)} rows "
                         f"(a kernel of {filt.shape[0]} rows over too many devices)")
    out = []
    for b, ext in zip(blocks, _extend(blocks, lo, hi)):
        hh = None if h_hat is None else _at(h_hat, b.device)
        out.append(_local_conv_same(ext, _on(filt, b.device), o0, o1, hh)[lo : lo + b.shape[0]])
    return tuple(out)


def sharded_conv2d(blocks, filt: torch.Tensor, h_hat=None) -> tuple:
    """The row-sharded 'same' 2-D convolution, globally ``ops.Convolve2D``
    (centre ``m // 2``, zero boundary); ``h_hat = conv_transfer(filt,
    (h_loc + m0 - 1, W))`` spares the filter's FFT."""
    m0, m1 = filt.shape
    return _os_conv(blocks, filt, m0 // 2, m1 // 2, h_hat)


def sharded_conv2d_adjoint(blocks, filt: torch.Tensor, h_hat=None) -> tuple:
    """Its adjoint, the correlation: the flipped kernel at the complementary
    offset (``h_hat``, when given, is the flipped kernel's transfer)."""
    m0, m1 = filt.shape
    return _os_conv(blocks, torch.flip(filt, (0, 1)), m0 - 1 - m0 // 2, m1 - 1 - m1 // 2, h_hat)


def sharded_conv2d_gram(blocks, filt: torch.Tensor, acorr_hat=None) -> tuple:
    """The row-sharded fused Gram ``A^H A x`` of the 'same' convolution,
    globally ``ops.ConvGram2D``: the overlap-save convolution by the
    kernel's autocorrelation (``m0 - 1`` halo rows; ``acorr_hat`` its
    transfer for blocks of ``(h_loc + 2 (m0 - 1), W)``), less the frame
    corrections (``ops/_gram.py``): the top rows' on the first block, the
    bottom rows' on the last, the left and right columns' on every block
    from its ``m0 - 1``-row extension.  Blocks must be at least as tall as
    the kernel and the image at least ``2 m1 - 1`` wide."""
    hl, W = blocks[0].shape
    m0, m1 = filt.shape
    if hl < m0:
        raise ValueError("local block must be at least as tall as the kernel")
    if W < 2 * m1 - 1:
        raise ValueError(f"image width {W} must be >= 2*m1-1 = {2 * m1 - 1}")
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    p0, n = m0 - 1, len(blocks)
    H = n * hl
    f = torch.flip(filt, (0, 1))
    acorr = conv_full_direct(filt, f)  # (2 m0 - 1, 2 m1 - 1)
    g = list(_os_conv(blocks, acorr, p0, m1 - 1, acorr_hat))
    ext = _extend(blocks, p0, p0) if o1 > 0 or b1 > 0 else None
    for i, b in enumerate(blocks):
        h_, f_ = _on(filt, b.device), _on(f, b.device)
        if o0 > 0 and i == 0:  # the image's top rows
            st = conv_full_direct(b[:m0], h_)[:o0]
            g[i][:o0] -= conv_full_direct(st, f_)[m0 - 1 : m0 - 1 + o0, m1 - 1 : m1 - 1 + W]
        if b0 > 0 and i == n - 1:  # its bottom rows
            sb = conv_full_direct(b[hl - (m0 - 1):], h_)[o0 + m0 - 1 : o0 + m0 - 1 + b0]
            g[i][hl - b0:] -= conv_full_direct(sb, f_)[0:b0, m1 - 1 : m1 - 1 + W]
        if ext is None:
            continue
        # the rows of the extension that are rows of the full image's middle
        rows = torch.arange(hl + 2 * p0 + m0 - 1, device=b.device)[:, None] + (i * hl - p0)
        mid = ((rows >= o0) & (rows < o0 + H)).to(b.dtype)
        if o1 > 0:
            sl = conv_full_direct(ext[i][:, :o1], h_)[:, :o1] * mid
            g[i][:, :o1] -= conv_full_direct(sl, f_)[2 * p0 : 2 * p0 + hl, m1 - 1 : m1 - 1 + o1]
        if b1 > 0:
            sr = conv_full_direct(ext[i][:, W - (m1 - 1):], h_)[:, o1 + m1 - 1 : o1 + m1 - 1 + b1] * mid
            g[i][:, W - b1:] -= conv_full_direct(sr, f_)[2 * p0 : 2 * p0 + hl, 0:b1]
    return tuple(g)


def _gram_band_rows_halo(blocks, g_rows, row_edges: bool = True) -> tuple:
    """The band Gram pass along the sharded rows: each block grown by ``K -
    1`` rows of its neighbours, the band, cropped; the edge corrections on
    the first and last blocks (``row_edges``).  ``g_rows = (acorr, E_top,
    E_bot, L)`` as :func:`~pycsou_tpu_torch.kernels.band.gram_band_rows`
    takes it."""
    acorr, E_top, E_bot, L = g_rows
    h = (acorr.numel() - 1) // 2
    out = [band_conv(ext, _on(acorr, b.device), h, 0)[h : h + b.shape[0]]
           for b, ext in zip(blocks, _extend(blocks, h, h))]
    if E_top is not None and row_edges:
        k1, first, last = E_top.shape[0], blocks[0], blocks[-1]
        with full_f32():
            out[0][:k1] += _on(E_top, first.device) @ first[:L]
            out[-1][-k1:] += _on(E_bot, last.device) @ last[-L:]
    return tuple(out)


def sharded_sepgram_rank1(blocks, g_rows, g_cols) -> tuple:
    """The row-sharded band Gram ``A^H A x`` of a rank-1 PSF, no FFT: the
    column pass local to each block (``gram_band_cols``, W not cut), then
    the row pass over ``K - 1`` halo rows with the edge corrections on the
    first and last blocks.  Blocks of at least ``max(K - 1, 2 K - 2)``
    rows."""
    def cols_on(dev):
        a, et, eb, L = g_cols
        return (_on(a, dev), None if et is None else _on(et, dev), None if eb is None else _on(eb, dev), L)

    return _gram_band_rows_halo([gram_band_cols(b, cols_on(b.device)) for b in blocks], g_rows)


def pdot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The inner product of two sharded arrays (real), the blocks' sums
    added on the first block's device; given a mesh that spans processes,
    ``a`` and ``b`` are this process's blocks and the sums go through
    :func:`~pycsou_tpu_torch.parallel.mesh.psum`."""
    if mesh is not None:
        return psum([torch.sum(x * y) for x, y in zip(a, b)], mesh)
    dev = a[0].device
    return functools.reduce(torch.add, [_on(torch.sum(x * y), dev) for x, y in zip(a, b)])


def pnorm(a: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The 2-norm of a sharded array."""
    return torch.sqrt(pdot(a, a, mesh))


# -- the 2-D mesh: grids of blocks ---------------------------------------------------


def sharded_fdiff_cols(grid, step: float = 1.0) -> tuple:
    """The column-wise forward difference of a grid, globally
    ``ops.diff.fdiff_forward(x, 1)`` (last column of the image 0)."""
    out = []
    for row in grid:
        r = []
        for j, (b, nxt) in enumerate(zip(row, halo_from_next_cols(row, 1))):
            ext = torch.cat([b, nxt], dim=1)
            d = (ext[:, 1:] - ext[:, :-1]) / step
            if j == len(row) - 1:
                d[:, -1] = 0.0
            r.append(d)
        out.append(tuple(r))
    return tuple(out)


def sharded_fdiff_cols_adjoint(grid, step: float = 1.0) -> tuple:
    """Its adjoint, with the image's last column of ``y`` taken as 0."""
    out = []
    for row in grid:
        ys = list(row)
        ys[-1] = torch.cat([ys[-1][:, :-1], torch.zeros_like(ys[-1][:, -1:])], dim=1)
        out.append(tuple((ext[:, :-1] - ext[:, 1:]) / step for ext in _extend_cols(ys, 1, 0)))
    return tuple(out)


def _rows_2d(fn, grid, *args) -> tuple:
    """``fn`` of the 1-D mesh applied down each mesh column of a grid."""
    return _grid_of_columns([fn(col, *args) for col in _columns(grid)])


def sharded_grad2d_2d(grid, step: float = 1.0) -> tuple:
    """The (2, h, w) forward-difference gradient of each block of a grid."""
    d0, d1 = _rows_2d(sharded_fdiff_rows, grid, step), sharded_fdiff_cols(grid, step)
    return tuple(tuple(torch.stack([a, b]) for a, b in zip(r0, r1)) for r0, r1 in zip(d0, d1))


def sharded_grad2d_adjoint_2d(grid, step: float = 1.0) -> tuple:
    """Its adjoint on a grid of (2, h, w) blocks."""
    rows = _rows_2d(sharded_fdiff_rows_adjoint, tuple(tuple(g[0] for g in r) for r in grid), step)
    cols = sharded_fdiff_cols_adjoint(tuple(tuple(g[1] for g in r) for r in grid), step)
    return tuple(tuple(a + b for a, b in zip(ra, rb)) for ra, rb in zip(rows, cols))


def _gram_band_cols_halo(grid, g_cols) -> tuple:
    """The band Gram pass along the sharded columns: ``K - 1`` halo columns,
    the edge corrections on the first and last mesh columns."""
    acorr, E_top, E_bot, L = g_cols
    h = (acorr.numel() - 1) // 2
    out = []
    for row in grid:
        r = [band_conv(ext, _on(acorr, b.device), h, 1)[:, h : h + b.shape[1]]
             for b, ext in zip(row, _extend_cols(row, h, h))]
        if E_top is not None:
            k1, first, last = E_top.shape[0], row[0], row[-1]
            with full_f32():
                r[0][:, :k1] += first[:, :L] @ _on(E_top, first.device).T
                r[-1][:, -k1:] += last[:, -L:] @ _on(E_bot, last.device).T
        out.append(tuple(r))
    return tuple(out)


def _sep_halo_pass(grid, taps: torch.Tensor, offset: int, rows: bool) -> tuple:
    """One 'same' band pass by ``taps`` at ``offset`` along a sharded axis:
    ``K - 1 - offset`` rows (columns) of the previous neighbour and
    ``offset`` of the next, the local pass, cropped; the zero halos at the
    image's edges are the zero boundary, so the pass is globally exact."""
    lo, hi = taps.numel() - 1 - offset, offset
    if rows:
        def col_pass(col):
            return tuple(band_conv(e, _on(taps, b.device), offset, 0)[lo : lo + b.shape[0]]
                         for b, e in zip(col, _extend(col, lo, hi)))

        return _rows_2d(col_pass, grid)
    return tuple(tuple(band_conv(e, _on(taps, b.device), offset, 1)[:, lo : lo + b.shape[1]]
                       for b, e in zip(row, _extend_cols(row, lo, hi))) for row in grid)


def sharded_sepconv2d_2d(grid, rows_plan, cols_plan) -> tuple:
    """The separable 'same' 2-D convolution by ``u v^T`` on a grid, globally
    ``ops.Convolve2D``: ``rows_plan = (u, offset)`` and ``cols_plan = (v,
    offset)`` (float32 tap tensors, the offsets ``m // 2``); the column
    pass, then the row pass, each over its own halos.  No FFT."""
    (rt, ro), (ct, co) = rows_plan, cols_plan
    return _sep_halo_pass(_sep_halo_pass(grid, ct, co, rows=False), rt, ro, rows=True)


def sharded_sepconv2d_adjoint_2d(grid, rows_plan, cols_plan) -> tuple:
    """Its adjoint: the same passes with the flipped taps at the
    complementary offsets ``m - 1 - m // 2``, which the caller gives."""
    return sharded_sepconv2d_2d(grid, rows_plan, cols_plan)


def sharded_sepgram_rank1_2d(grid, g_rows, g_cols) -> tuple:
    """The band Gram ``A^H A x`` of a rank-1 PSF on a grid: the column pass
    over ``K - 1`` halo columns, then the row pass over ``K - 1`` halo rows,
    each with its edge corrections on the image's edges.  Blocks of at least
    ``max(K - 1, 2 K - 2)`` rows and columns."""
    return _rows_2d(_gram_band_rows_halo, _gram_band_cols_halo(grid, g_cols), g_rows)
