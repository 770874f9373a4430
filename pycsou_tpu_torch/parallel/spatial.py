"""Row-halo exchange between the blocks of a row-sharded image (counterpart
of ``pycsou_tpu/parallel/spatial.py`` ``halo_from_prev``/``halo_from_next``).

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

The rest of the reference's module (the sharded FFT convolutions and Grams,
the 2-D mesh helpers) is not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import List, Sequence

import functools

import torch

__all__ = ["halo_from_prev", "halo_from_next", "halo_extend", "halos"]


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
