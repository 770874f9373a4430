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

The rest of the reference's module (the sharded FFT convolutions and Grams)
is not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import List, Sequence

import functools

import torch

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
]


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


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
