"""The exact 1-D 'same'-convolution Gram as a band plus edge corrections
(counterpart of ``pycsou_tpu/kernels/band.py``).

For the K-tap 'same' convolution matrix ``T`` (offset K // 2, zero
boundary), ``T^H T`` is the Toeplitz matrix of the (2K - 1)-tap
autocorrelation, except in its first and last K - 1 rows, where the 'same'
crop removes terms.  :func:`make_gram_band` returns the autocorrelation and
those two (K - 1, L) corrections, acting on the first and last ``L = 2K - 2``
samples.  For a rank-1 PSF the 2-D Gram is ``RowGram o ColGram``: two band
passes of 2K - 1 taps where the forward-and-adjoint form needs four of K.
The rank-1 engines (``kernels/tv.py`` K10-K12) compute it in their kernels;
:func:`gram_band_rows` and :func:`gram_band_cols` are its plain PyTorch
form, and :func:`gram_band_axis` takes it along any axis of an N-D tensor
(the per-axis passes of ``ops.conv.SeparableConvGramND``).

:func:`band_conv` is the 'same' convolution by any K taps at an offset
along one axis, the reference's ``band_conv_rows``/``band_conv_cols``
(the sharded chain's separable passes, ``parallel/spatial.py``).  The
reference's MXU formulations of the band (``make_band_blocks``,
``make_chanconv``, ``chanconv_cols``, ``gram_chanconv_cols``) are TPU
tiling of the same band pass and have no counterpart here.  ``TILE`` is
the reference's tile edge, kept because its gates read it: a (2K - 1)-tap
band needs ``2 (K - 1) <= TILE``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pycsou_tpu_torch.utils.device import full_f32

__all__ = ["TILE", "band_conv", "make_gram_band", "gram_band_rows", "gram_band_cols", "gram_band_axis"]

TILE = 128  # the reference's band tile (``pycsou_tpu/kernels/band.py``)


def make_gram_band(taps, n: int):
    """``(acorr, E_top, E_bot, L)`` of the exact 1-D Gram of the K-tap
    'same' convolution on n samples: the (2K - 1,) float64 autocorrelation
    and the two (K - 1, L) float32 corrections (None, None, 0 for K = 1).
    The reference's numpy, so every output is bit-equal to its
    (``make_gram_band`` returns the MXU plan of ``acorr`` in its place)."""
    taps = np.asarray(taps, np.float64).reshape(-1)
    K = taps.size
    if K == 1:
        return taps * taps, None, None, 0
    if n < 3 * K:
        raise ValueError("signal too short for windowed edge corrections")
    acorr = np.convolve(taps, taps[::-1])  # (2K-1,), symmetric
    # exact Gram on a window; deviations from Toeplitz live in the corners
    o = K // 2
    n_w = 3 * K
    T = np.zeros((n_w, n_w))
    for j in range(n_w):
        for k in range(K):
            p = j - k + o
            if 0 <= p < n_w:
                T[j, p] += taps[k]
    G = T.T @ T
    Gt = np.zeros_like(G)
    for d in range(-(K - 1), K):
        idx = np.arange(max(0, -d), min(n_w, n_w - d))
        Gt[idx + d, idx] = acorr[K - 1 + d]
    E = G - Gt
    L = 2 * K - 2
    E_top = E[: K - 1, :L].astype(np.float32)
    E_bot = E[n_w - (K - 1) :, n_w - L :].astype(np.float32)
    return acorr, E_top, E_bot, L


def band_conv(x: torch.Tensor, taps: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """The zero-boundary 'same' convolution ``out[j] = sum_k taps[k] x[j - k
    + offset]`` along ``axis`` (0 or 1) of a 2-D image, at full f32 (the
    reference's ``band_conv_rows``/``band_conv_cols`` with the plan
    ``make_band_blocks(taps, offset)``); ``taps`` a float32 tensor on
    ``x``'s device.  ``F.conv2d`` correlates, so the taps are flipped."""
    K = taps.numel()
    lead = K - 1 - offset
    shape = (1, 1, K, 1) if axis == 0 else (1, 1, 1, K)
    pad = (0, 0, lead, offset) if axis == 0 else (lead, offset, 0, 0)
    with full_f32():
        return F.conv2d(F.pad(x[None, None], pad), taps.flip(0).reshape(shape))[0, 0]


def _band(x: torch.Tensor, acorr: torch.Tensor, axis: int) -> torch.Tensor:
    """The band pass ``out[j] = sum_d acorr[K - 1 + d] x[j + d]`` of the
    symmetric (2K - 1)-tap autocorrelation."""
    return band_conv(x, acorr, (acorr.numel() - 1) // 2, axis)


def gram_band_rows(x: torch.Tensor, gplan) -> torch.Tensor:
    """Exact 1-D conv Gram along the FIRST axis: one band pass plus the two
    thin edge-correction products.  ``gplan = (acorr, E_top, E_bot, L)``
    with ``acorr`` a float32 tensor on ``x``'s device and the corrections
    float32 tensors there (or None)."""
    acorr, E_top, E_bot, L = gplan
    out = _band(x, acorr, 0)
    if E_top is not None:
        k1 = E_top.shape[0]
        with full_f32():
            top, bot = E_top @ x[:L], E_bot @ x[-L:]
        out = torch.cat([out[:k1] + top, out[k1:-k1], out[-k1:] + bot])
    return out


def gram_band_cols(x: torch.Tensor, gplan) -> torch.Tensor:
    """Exact 1-D conv Gram along the LAST axis (see :func:`gram_band_rows`)."""
    acorr, E_top, E_bot, L = gplan
    out = _band(x, acorr, 1)
    if E_top is not None:
        k1 = E_top.shape[0]
        with full_f32():
            top, bot = x[:, :L] @ E_top.T, x[:, -L:] @ E_bot.T
        out = torch.cat([out[:, :k1] + top, out[:, k1:-k1], out[:, -k1:] + bot], dim=1)
    return out


def gram_band_axis(x: torch.Tensor, gplan, axis: int) -> torch.Tensor:
    """Exact 1-D conv Gram along any ``axis`` of an N-D tensor: the other
    axes collapsed, the band pass and edge corrections of
    :func:`gram_band_rows` (first axis) or :func:`gram_band_cols`, the
    shape restored."""
    axis = axis % x.ndim
    shp = x.shape
    if axis == 0:
        return gram_band_rows(x.reshape(shp[0], -1), gplan).reshape(shp)
    xm = x.movedim(axis, -1)
    out = gram_band_cols(xm.reshape(-1, shp[axis]), gplan).reshape(xm.shape)
    return out.movedim(-1, axis)
