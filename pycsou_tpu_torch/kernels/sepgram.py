"""``A^H A x`` of a 'same' zero-boundary convolution with a low-rank PSF
``h = sum_i outer(us[i], vs[i])`` (K18) and its plain version.

K18 computes K2's function without ``atb`` (``kernels/conv2d.py``
``sepgram2d``): the forward taps at the offset ``K // 2``, the adjoint with
flipped taps at ``K - 1 - K // 2`` on each axis, which are the reference's
``o``/``b`` offsets for odd and even tap counts alike.  It launches K2's
kernel (``pct_sepgram2d``) and counts on its own wrapper.

Deliberate differences from the reference: ``sepgram_geometry``, the
TPU's VMEM tiling plan (row tiles, lane padding, the ~0.8 MB budget), has
no counterpart, and its gate (a row tile dividing ``H``) is dropped: the
kernel tiles any image, so :func:`sepgram_available` is true.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from pycsou_tpu_torch.kernels._build import launch
from pycsou_tpu_torch.kernels.conv2d import SepFactors, _check_device, _check_image, gram_taps, sepgram2d_plain

__all__ = ["sepgram_apply", "sepgram_apply_plain", "sepgram_available"]


def sepgram_available() -> bool:
    """True: K18 has no geometry gate (the reference's asks whether its
    Element-indexed Pallas blocks exist)."""
    return True


def _taps(us, vs):
    """``us``/``vs`` as tuples of per-rank tuples of floats, checked."""
    us = tuple(tuple(float(t) for t in u) for u in us)
    vs = tuple(tuple(float(t) for t in v) for v in vs)
    if not us or len(us) != len(vs) or len({len(u) for u in us}) != 1 or len({len(v) for v in vs}) != 1:
        raise ValueError("us and vs: one tap tuple per rank, of one length each")
    return us, vs


@functools.lru_cache(maxsize=16)
def _factors(us, vs, device):
    """The forward and adjoint factor stacks on ``device`` (built once)."""
    m0, m1 = len(us[0]), len(vs[0])
    fwd = SepFactors(np.asarray(us, np.float64).T, np.asarray(vs, np.float64).T, m0 // 2, m1 // 2, device)
    return fwd, fwd.adjoint()


def sepgram_apply_plain(x: torch.Tensor, us, vs) -> torch.Tensor:
    """Plain PyTorch version of K18: the adjoint convolution of the forward
    one (``kernels.conv2d.sepgram2d_plain`` without ``atb``)."""
    fwd, adj = _factors(*_taps(us, vs), x.device)
    return sepgram2d_plain(x, fwd, adj)


def sepgram_apply(x: torch.Tensor, us, vs) -> torch.Tensor:
    """K18: ``A^H A x`` for ``h = sum_i outer(us[i], vs[i])``; ``us``/``vs``
    per-rank tap sequences (rank <= 4, at most 31 taps an axis).

    Replaces ``pycsou_tpu/kernels/sepgram.py`` ``sepgram_apply``
    (``_sepgram_kernel``).  Bound by device memory: 2 image streams (x in,
    g out); ``t = A x`` stays in shared memory."""
    _check_image(x, "x")
    fwd, adj = _factors(*_taps(us, vs), x.device)
    _check_device(x, fwd, adj)
    if x.device.type == "cpu":
        return sepgram2d_plain(x, fwd, adj)
    H, W = x.shape
    g = torch.empty_like(x)
    taps = gram_taps(fwd, adj)
    launch(
        "pct_sepgram2d", "sepgram_apply", x,
        x.data_ptr(), 0, g.data_ptr(), H, W, taps.ctypes.data, fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov,
        adj.ou, adj.ov, 2.0,
    )
    sepgram_apply.launches += 1
    return g


sepgram_apply.launches = 0
