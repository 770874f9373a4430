"""Halo exchange between the blocks of a sharded image (counterpart of
``pycsou_tpu/parallel/spatial.py`` ``halo_from_prev``/``halo_from_next`` and
``halo_from_prev_cols``/``halo_from_next_cols``).

A row-sharded image is a sequence of ``(h_loc, W)`` blocks in mesh order,
each on its mesh position's device.  Where the reference's ``ppermute``
sends rows to the neighbouring device, here each block receives them:
a neighbour's rows on the same device are a view of its block (a row slice
of a contiguous block is contiguous), on another device of this process a
copy (``.to(device, non_blocking=True)``; under a profiler the counter
``sp.halo_bytes`` adds up the bytes copied between two cards or sent to
another process).  On a mesh that spans processes a sequence has one entry a
position, a :class:`~pycsou_tpu_torch.utils.device.Remote` where another
process holds the block (``Mesh.place``): a neighbour in another process
sends its rows, and each exchange posts every halo that crosses a process
boundary in one batch (``parallel.mesh.transfer``); every process must
make the same calls, and a result holds the same ``Remote`` entries.
Rows beyond the image's first and last rows are zeros, the zero boundary
of the Gram and of the finite differences; such a block is made once for
each shape, dtype and device and then shared, so a caller must not write
into a halo.

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
mesh; :func:`pdot` and :func:`pnorm` add the blocks' sums in mesh order on
the first local block's device (the reference's ``psum``,
``parallel.mesh.fold``), the other processes' sums gathered first.  A
filter, transfer or plan is given once, or for a transfer as a dict of
one copy a device: where a block lives on another device, a lone copy is
copied there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import functools

import torch

from pycsou_tpu_torch.kernels.band import band_conv, gram_band_cols
from pycsou_tpu_torch.ops._gram import conv_full_direct
from pycsou_tpu_torch.ops.conv import next_fast_len
from pycsou_tpu_torch.ops.diff import fdiff_forward, fdiff_forward_adjoint
from pycsou_tpu_torch.parallel.mesh import Mesh, _rank, each, fold, psum, transfer
from pycsou_tpu_torch.utils.device import Remote, full_f32
from pycsou_tpu_torch.utils.profiling import count

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


def _edge_zeros(block, h: int, axis: int = 0):
    """The zeros beyond the image: ``block``'s shape with ``h`` along
    ``axis`` (made once and shared; a :class:`Remote` stays one)."""
    if isinstance(block, Remote):
        return block
    shape = list(block.shape)
    shape[axis] = h
    return _zero_block(tuple(shape), block.dtype, block.device)


def _check(blocks: Sequence, h: int, axis: int = 0) -> None:
    sizes = [b.shape[axis] for b in blocks if not isinstance(b, Remote)]
    if h < 0 or any(h > n for n in sizes):
        raise ValueError(f"{h} halo {('rows', 'columns')[axis]} from blocks of {sizes} {('rows', 'columns')[axis]}")


def _fetch(requests) -> list:
    """``(src, take, dst)`` requests, in an order that every process builds
    alike: ``take(src)`` on ``dst``'s device (a view on the same device, a
    copy on another of this process's, sent across processes), a
    :class:`Remote` where another process holds ``dst``.  What crosses a
    process boundary goes in one batch."""
    me = _rank()
    out, msgs, slots = [], [], []
    moved = 0
    for tag, (src, take, dst) in enumerate(requests):
        if isinstance(dst, Remote):
            out.append(dst)
            if not isinstance(src, Remote):
                piece = take(src)
                moved += piece.numel() * piece.element_size()
                msgs.append((tag, me, dst.rank, piece, None))
        elif isinstance(src, Remote):
            # the piece has the shape of the same piece of the receiving block
            slots.append(len(out))
            out.append(None)
            msgs.append((tag, src.rank, me, None, take(dst)))
        else:
            piece = take(src)
            if piece.device != dst.device:
                moved += piece.numel() * piece.element_size()
            out.append(_on(piece, dst.device))
    if moved:
        count("sp.halo_bytes", moved)
    if msgs:
        got = [g for g in transfer(msgs) if g is not None]
        for k, g in zip(slots, got):
            out[k] = g
    return out


def _row_halos(chains, lo: int, hi: int, axis: int = 0) -> list:
    """For each sequence of blocks in ``chains`` (a mesh column, cut along
    the rows; with ``axis=1`` a mesh row, cut along the columns),
    ``(before, after)``: for each block the last ``lo`` rows (columns) of
    the previous block and the first ``hi`` of the next, on its own device
    (zeros beyond the image), in one exchange.  A neighbour's piece on the
    same device is a view (not contiguous along the columns)."""
    reqs, slots, out = [], [], []
    for blocks in chains:
        _check(blocks, max(lo, hi), axis)
        n = len(blocks)
        before, after = [None] * n, [None] * n
        for i, b in enumerate(blocks):
            if i == 0 or lo == 0:
                before[i] = _edge_zeros(b, lo, axis)
            else:
                reqs.append((blocks[i - 1], lambda s: s.narrow(axis, s.shape[axis] - lo, lo), b))
                slots.append((before, i))
            if i == n - 1 or hi == 0:
                after[i] = _edge_zeros(b, hi, axis)
            else:
                reqs.append((blocks[i + 1], lambda s: s.narrow(axis, 0, hi), b))
                slots.append((after, i))
        out.append((before, after))
    for (lst, i), v in zip(slots, _fetch(reqs)):
        lst[i] = v
    return out


def halo_from_prev(blocks: Sequence[torch.Tensor], h: int) -> List[torch.Tensor]:
    """For each block, the last ``h`` rows of the previous block, on its own
    device (zeros for the first block)."""
    return _row_halos([blocks], h, 0)[0][0]


def halo_from_next(blocks: Sequence[torch.Tensor], h: int) -> List[torch.Tensor]:
    """For each block, the first ``h`` rows of the next block, on its own
    device (zeros for the last block)."""
    return _row_halos([blocks], 0, h)[0][1]


def halo_extend(blocks: Sequence[torch.Tensor], h: int) -> List[torch.Tensor]:
    """Each block with ``h`` rows of its neighbours above and below, ``(h_loc
    + 2h, W)`` (the reference solver's ``_make_ext``)."""
    (tops, bots), = _row_halos([blocks], h, h)
    return each(lambda b, t, d: torch.cat([t, b, d]), blocks, tops, bots)


def halos(arrays: Sequence[Sequence[torch.Tensor]], h: int) -> List[tuple]:
    """For each shard, the ``h`` rows above and below it of each row-sharded
    array in ``arrays``, interleaved as the shard kernels take them:
    ``(a_top, a_bot, b_top, b_bot, ...)``; one exchange for them all."""
    per = _row_halos(arrays, h, h)
    return [arrays[0][i] if isinstance(arrays[0][i], Remote) else
            tuple(t for top, bot in per for t in (top[i], bot[i])) for i in range(len(arrays[0]))]


# -- the 2-D mesh: column halos and the grid of blocks ------------------------------


def halo_from_prev_cols(blocks: Sequence[torch.Tensor], c: int) -> List[torch.Tensor]:
    """For each block of a mesh row (left to right), the last ``c`` columns
    of its left neighbour, contiguous, on its own device (zeros for the
    first)."""
    return each(lambda t: t.contiguous(), _row_halos([blocks], c, 0, axis=1)[0][0])


def halo_from_next_cols(blocks: Sequence[torch.Tensor], c: int) -> List[torch.Tensor]:
    """For each block of a mesh row, the first ``c`` columns of its right
    neighbour, contiguous, on its own device (zeros for the last)."""
    return each(lambda t: t.contiguous(), _row_halos([blocks], 0, c, axis=1)[0][1])


def lane_extend(grid: Sequence[Sequence[torch.Tensor]], c: int) -> tuple:
    """Each block of the grid with ``c`` columns of its left and right
    neighbours, ``(h_loc, w_loc + 2c)``, zeros beyond the image (one copy a
    block)."""
    per = _row_halos(grid, c, c, axis=1)
    return tuple(tuple(each(lambda b, a, d: torch.cat([a, b, d], dim=1), row, left, right))
                 for row, (left, right) in zip(grid, per))


def _columns(grid):
    """The mesh columns of a grid: each a row-sharded sequence of blocks."""
    return [[row[j] for row in grid] for j in range(len(grid[0]))]


def halos_2d(grids: Sequence[Sequence[Sequence[torch.Tensor]]], h: int) -> tuple:
    """For each block of the grids (lane-extended by :func:`lane_extend`),
    the ``h`` rows above and below it of each grid, interleaved as
    :func:`halos` gives them, as a grid of tuples.  Taken from the
    lane-extended blocks of the row neighbours, they hold the diagonal
    neighbours' corner columns; one exchange for them all."""
    cols = [_columns(g) for g in grids]
    n0, n1 = len(grids[0]), len(cols[0])
    per = _row_halos([c[j] for j in range(n1) for c in cols], h, h)  # column j of grid g: per[j * G + g]
    G = len(grids)

    def block(i, j):
        if isinstance(grids[0][i][j], Remote):
            return grids[0][i][j]
        return tuple(t for g in range(G) for t in (per[j * G + g][0][i], per[j * G + g][1][i]))

    return tuple(tuple(block(i, j) for j in range(n1)) for i in range(n0))


def halo_extend_2d(grid: Sequence[Sequence[torch.Tensor]], h: int, c: int) -> tuple:
    """Each block with ``h`` rows and ``c`` columns of its neighbours (the
    corners from its diagonal neighbours), ``(h_loc + 2h, w_loc + 2c)``,
    zeros beyond the image."""
    cols = _columns(lane_extend(grid, c))
    ext = [each(lambda b, t, d: torch.cat([t, b, d]), col, tops, bots)
           for col, (tops, bots) in zip(cols, _row_halos(cols, h, h))]
    return _grid_of_columns(ext)


def _grid_of_columns(cols) -> tuple:
    """The grid whose mesh columns are ``cols`` (the inverse of
    :func:`_columns`)."""
    return tuple(tuple(col[i] for col in cols) for i in range(len(cols[0])))


def _extend(blocks: Sequence[torch.Tensor], lo: int, hi: int) -> List[torch.Tensor]:
    """Each block with ``lo`` rows of the previous block above and ``hi`` of
    the next below (zeros beyond the image)."""
    if not (lo or hi):
        return list(blocks)
    (tops, bots), = _row_halos([blocks], lo, hi)
    return each(lambda b, t, d: torch.cat([t, b, d]), blocks, tops, bots)


def _extend_cols(row: Sequence[torch.Tensor], lo: int, hi: int) -> List[torch.Tensor]:
    """Each block of a mesh row with ``lo`` columns of its left neighbour and
    ``hi`` of its right one (zeros beyond the image)."""
    if not (lo or hi):
        return list(row)
    (lefts, rights), = _row_halos([row], lo, hi, axis=1)
    return each(lambda b, a, d: torch.cat([a.contiguous(), b, d.contiguous()], dim=1), row, lefts, rights)


# -- the 1-D mesh: row blocks --------------------------------------------------------


def sharded_fdiff_rows(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """The row-wise forward difference of a row-sharded image, globally
    ``ops.diff.fdiff_forward(x, 0)`` (last row of the image 0)."""
    out = []
    for i, (b, nxt) in enumerate(zip(blocks, halo_from_next(blocks, 1))):
        if isinstance(b, Remote):
            out.append(b)
            continue
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
    if not isinstance(ys[-1], Remote):
        ys[-1] = torch.cat([ys[-1][:-1], torch.zeros_like(ys[-1][-1:])])
    return tuple(each(lambda ext: (ext[:-1] - ext[1:]) / step, _extend(ys, 1, 0)))


def sharded_grad2d(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """The (2, h, W) forward-difference gradient of each row block, globally
    ``ops.diff.Gradient``."""
    return tuple(each(lambda d0, b: torch.stack([d0, fdiff_forward(b, 1, step)]),
                      sharded_fdiff_rows(blocks, step), blocks))


def sharded_grad2d_adjoint(blocks: Sequence[torch.Tensor], step: float = 1.0) -> tuple:
    """Its adjoint on (2, h, W) blocks."""
    rows = sharded_fdiff_rows_adjoint(each(lambda g: g[0], blocks), step)
    return tuple(each(lambda r, g: r + fdiff_forward_adjoint(g[1], 1, step), rows, blocks))


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
    rows = [b.shape[0] for b in blocks if not isinstance(b, Remote)]
    if any(max(lo, hi) > r for r in rows):
        raise ValueError(f"blocks of {rows[0]} rows are shorter than the halo of {max(lo, hi)} rows "
                         f"(a kernel of {filt.shape[0]} rows over too many devices)")

    def one(b, ext):
        hh = None if h_hat is None else _at(h_hat, b.device)
        return _local_conv_same(ext, _on(filt, b.device), o0, o1, hh)[lo : lo + b.shape[0]]

    return tuple(each(one, blocks, _extend(blocks, lo, hi)))


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
    hl, W = next(b for b in blocks if not isinstance(b, Remote)).shape
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
        if isinstance(b, Remote):
            continue
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
    out = each(lambda b, ext: band_conv(ext, _on(acorr, b.device), h, 0)[h : h + b.shape[0]],
               blocks, _extend(blocks, h, h))
    if E_top is not None and row_edges:
        k1, first, last = E_top.shape[0], blocks[0], blocks[-1]
        with full_f32():
            if not isinstance(first, Remote):
                out[0][:k1] += _on(E_top, first.device) @ first[:L]
            if not isinstance(last, Remote):
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

    return _gram_band_rows_halo(each(lambda b: gram_band_cols(b, cols_on(b.device)), blocks), g_rows)


def pdot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The inner product of two sharded arrays (real), the blocks' sums
    added in mesh order on the first local block's device
    (:func:`~pycsou_tpu_torch.parallel.mesh.fold`: the sums of another
    process's blocks, :class:`Remote` entries, gathered first); given a
    mesh, ``a`` and ``b`` may be this process's blocks only and the sums
    go through :func:`~pycsou_tpu_torch.parallel.mesh.psum`."""
    if mesh is not None:
        return psum(each(lambda x, y: torch.sum(x * y), a, b), mesh)
    return fold(each(lambda x, y: torch.sum(x * y), a, b))


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
            if isinstance(b, Remote):
                r.append(b)
                continue
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
        if not isinstance(ys[-1], Remote):
            ys[-1] = torch.cat([ys[-1][:, :-1], torch.zeros_like(ys[-1][:, -1:])], dim=1)
        out.append(tuple(each(lambda ext: (ext[:, :-1] - ext[:, 1:]) / step, _extend_cols(ys, 1, 0))))
    return tuple(out)


def _rows_2d(fn, grid, *args) -> tuple:
    """``fn`` of the 1-D mesh applied down each mesh column of a grid."""
    return _grid_of_columns([fn(col, *args) for col in _columns(grid)])


def sharded_grad2d_2d(grid, step: float = 1.0) -> tuple:
    """The (2, h, w) forward-difference gradient of each block of a grid."""
    d0, d1 = _rows_2d(sharded_fdiff_rows, grid, step), sharded_fdiff_cols(grid, step)
    return tuple(tuple(each(lambda a, b: torch.stack([a, b]), r0, r1)) for r0, r1 in zip(d0, d1))


def sharded_grad2d_adjoint_2d(grid, step: float = 1.0) -> tuple:
    """Its adjoint on a grid of (2, h, w) blocks."""
    rows = _rows_2d(sharded_fdiff_rows_adjoint, tuple(tuple(each(lambda g: g[0], r)) for r in grid), step)
    cols = sharded_fdiff_cols_adjoint(tuple(tuple(each(lambda g: g[1], r)) for r in grid), step)
    return tuple(tuple(each(torch.add, ra, rb)) for ra, rb in zip(rows, cols))


def _gram_band_cols_halo(grid, g_cols) -> tuple:
    """The band Gram pass along the sharded columns: ``K - 1`` halo columns,
    the edge corrections on the first and last mesh columns."""
    acorr, E_top, E_bot, L = g_cols
    h = (acorr.numel() - 1) // 2
    out = []
    for row in grid:
        r = each(lambda b, ext: band_conv(ext, _on(acorr, b.device), h, 1)[:, h : h + b.shape[1]],
                 row, _extend_cols(row, h, h))
        if E_top is not None:
            k1, first, last = E_top.shape[0], row[0], row[-1]
            with full_f32():
                if not isinstance(first, Remote):
                    r[0][:, :k1] += first[:, :L] @ _on(E_top, first.device).T
                if not isinstance(last, Remote):
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
            return tuple(each(lambda b, e: band_conv(e, _on(taps, b.device), offset, 0)[lo : lo + b.shape[0]],
                              col, _extend(col, lo, hi)))

        return _rows_2d(col_pass, grid)
    return tuple(tuple(each(lambda b, e: band_conv(e, _on(taps, b.device), offset, 1)[:, lo : lo + b.shape[1]],
                            row, _extend_cols(row, lo, hi))) for row in grid)


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
