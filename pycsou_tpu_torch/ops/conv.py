"""2-D convolution of the slice (counterpart of ``pycsou_tpu/ops/conv.py``).

* ``Convolve2D`` — 'same', zero-boundary convolution.  ``method='band'``
  (any PSF of rank <= 4 within 31 taps per axis) runs apply and adjoint
  through kernel K1; ``method='fft'`` applies through ``torch.fft`` and
  takes the autodiff adjoint.  ``'direct'`` and the grouped ``'bandg'``
  wait for ROADMAP Queue 1 item 2.
* ``SeparableConvGram2D`` — the exact Gram ``A^H A`` of a band convolution
  through kernel K2, and the fused least-squares gradient; for a rank-1
  PSF also the reference's rank-1 plan (``g_meta``, the autocorrelations,
  the raw taps and the edge corrections of ``kernels/band.py``), which the
  rank-1 TV engines K10-K12 read.
  ``ConvGram2D`` (the FFT Gram of ``ops/_gram.py``) waits for ROADMAP
  Queue 1 item 2; until then a full-rank PSF's Gram is the composition
  ``A^H o A``.

``lowrank_factors`` and ``_fft_lipschitz`` are the reference's numpy code
unchanged, so the factor taps and ``||A||`` (hence beta, tau and sigma)
come out bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator, LinOpComp, SymmetricLinearOperator
from pycsou_tpu_torch.kernels.band import make_gram_band
from pycsou_tpu_torch.kernels.conv2d import MAX_TAPS, SepFactors, sepconv2d, sepgram2d
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["Convolve2D", "SeparableConvGram2D", "lowrank_factors", "next_fast_len"]


def next_fast_len(n: int) -> int:
    """Smallest ``2^a * 3^b`` (``b <= 2``) >= n (the reference's FFT sizes)."""
    if n <= 2:
        return n
    best = 1 << (n - 1).bit_length()
    for mult in (3, 9):
        k = mult
        while k < n:
            k *= 2
        best = min(best, k)
    return best


def _fft_lipschitz(filt: np.ndarray, padded_shape: Tuple[int, ...]) -> float:
    """``||conv||_2 <= max |DFT_L(h)|`` for any ``L >= n + m - 1`` per axis
    (a rigorous bound: the 'same' convolution is a submatrix of the size-L
    circulant acting on zero-padded inputs)."""
    h = np.asarray(filt)
    L = tuple(next_fast_len(s) for s in padded_shape)
    axes = tuple(range(len(L)))
    if np.iscomplexobj(h):
        H = np.fft.fftn(h.astype(np.complex128), s=L, axes=axes)
    else:
        H = np.fft.rfftn(h.astype(np.float64), s=L, axes=axes)
    return float(np.max(np.abs(H)))


def lowrank_factors(filt_np: np.ndarray, tol: float = 1e-6, max_rank: int = 4):
    """SVD factorisation ``filt = sum_i u_i v_i^T`` truncated at relative
    singular value ``tol``; None if the numerical rank exceeds ``max_rank``."""
    f = np.asarray(filt_np, np.float64)
    if f.ndim != 2 or not np.isrealobj(f):
        return None
    U, S, Vt = np.linalg.svd(f)
    if S[0] == 0:
        return None
    r = int(np.sum(S > tol * S[0]))
    if r == 0 or r > max_rank:
        return None
    us = U[:, :r] * np.sqrt(S[:r])
    vs = Vt[:r].T * np.sqrt(S[:r])
    return us, vs  # (m0, r), (m1, r)


def _band_factors(filt_np: np.ndarray):
    """Factors when the PSF fits the separable kernels' gates (rank <= 4,
    at most MAX_TAPS taps per axis), else None."""
    if max(filt_np.shape) > MAX_TAPS:
        return None
    return lowrank_factors(filt_np)


class Convolve2D(LinearOperator):
    """2-D 'same' convolution with a compact kernel, zero boundary:
    ``y[p] = sum_k h[k] x[p + o - k]`` with ``o = K // 2`` per axis.

    ``method='auto'`` takes ``'band'`` when the PSF has rank <= 4 within
    31 taps per axis, else ``'fft'``."""

    def __init__(self, dim_shape, filt, method: str = "auto", device=None):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 2:
            raise ValueError("Convolve2D expects a 2-D domain")
        dev = resolve_device(device, filt)
        filt_np = (filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt))
        filt_np = filt_np.astype(np.float32)
        if filt_np.ndim != 2:
            raise ValueError("filter must be 2-D")
        if method in ("direct", "bandg"):
            raise NotImplementedError(
                f"Convolve2D method={method!r} is not ported yet (ROADMAP Queue 1 item 2)"
            )
        if method not in ("auto", "band", "fft"):
            raise ValueError("method must be 'auto', 'band' or 'fft'")
        fac = _band_factors(filt_np) if method in ("auto", "band") else None
        if method == "band" and fac is None:
            raise ValueError(f"kernel is not rank <= 4 within {MAX_TAPS} taps per axis")
        if method == "auto":
            method = "band" if fac is not None else "fft"
        padded = tuple(n + k - 1 for n, k in zip(dim_shape, filt_np.shape))
        super().__init__(dim_shape, dim_shape, lipschitz=_fft_lipschitz(filt_np, padded))
        self._device = dev
        self.filt = as_tensor(filt_np, dev)
        self.method = method
        self.factors = fac
        self.fwd = self.adj = None
        self.h_hat = None
        if method == "band":
            m0, m1 = filt_np.shape
            self.fwd = SepFactors(fac[0], fac[1], m0 // 2, m1 // 2, dev)
            self.adj = self.fwd.adjoint()
        else:
            s = tuple(next_fast_len(n + k - 1) for n, k in zip(dim_shape, filt_np.shape))
            self.h_hat = torch.fft.rfft2(self.filt, s=s)

    @property
    def device(self):
        return self._device

    def apply(self, x):
        if self.method == "band":
            return sepconv2d(x, self.fwd)
        (n0, n1), (m0, m1) = self.dim_shape, self.filt.shape
        o0, o1 = m0 // 2, m1 // 2
        s = (next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1))
        full = torch.fft.irfft2(torch.fft.rfft2(x, s=s) * self.h_hat, s=s)
        return full[o0 : o0 + n0, o1 : o1 + n1]

    def adjoint(self, y):
        if self.method == "band":
            return sepconv2d(torch.as_tensor(y), self.adj)
        return super().adjoint(y)

    @property
    def gram(self):
        """Exact ``A^H A``: the fused K2 Gram for a band convolution, else
        the composition ``A^H o A``."""
        if self.method == "band":
            return SeparableConvGram2D(self)
        return SymmetricLinearOperator(LinOpComp(self.H, self))


_ACORR_TILE = 128  # the reference's band tile: (2m - 1)-tap bands need 2 (m - 1) <= 128


class SeparableConvGram2D(LinearOperator):
    """Exact Gram ``A^H A`` of a band (rank <= 4) convolution, one K2 pass:
    the forward and adjoint convolutions are exact 'same' convolutions, so
    their composition needs no edge corrections.

    For a rank-1 PSF of m0 x m1 taps on an (H, W) image with ``H >= 3 m0``,
    ``W >= 3 m1`` and ``2 (m - 1) <= 128`` on both axes (the reference's
    gate, ``pycsou_tpu/ops/conv.py`` ``SeparableConvGram2D.__init__``) it
    also holds the rank-1 plan, bit-equal to the reference's: ``g_meta =
    (lead_r, L_r, lead_c, L_c)``, the autocorrelations ``g_rows_acorr`` /
    ``g_cols_acorr`` and raw factor taps ``g_rows_taps`` / ``g_cols_taps``
    (tuples of floats), and the edge corrections ``g_rows_E`` / ``g_cols_E``
    (``(E_top, E_bot)`` float32 tensors on the device, None for one tap).
    Otherwise ``g_meta`` is None."""

    def __init__(self, conv: Convolve2D):
        if conv.method != "band":
            raise ValueError("SeparableConvGram2D needs a Convolve2D with method='band'")
        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2)
        self._device = conv.device
        self.fwd = conv.fwd
        self.adj = conv.adj
        self.adj2 = conv.fwd.adjoint(2.0)  # the gradient's 2x in the adjoint row taps
        self.rank = conv.fwd.rank
        self.g_meta = self.g_rows_acorr = self.g_cols_acorr = None
        self.g_rows_taps = self.g_cols_taps = self.g_rows_E = self.g_cols_E = None
        us, vs = conv.factors
        (H, W), (m0, m1) = conv.dim_shape, (us.shape[0], vs.shape[0])
        if (self.rank == 1 and H >= 3 * m0 and W >= 3 * m1
                and 2 * (m0 - 1) <= _ACORR_TILE and 2 * (m1 - 1) <= _ACORR_TILE):
            acr, Etr, Ebr, L_r = make_gram_band(us[:, 0], H)
            acc, Etc, Ebc, L_c = make_gram_band(vs[:, 0], W)
            self.g_meta = (m0 - 1, L_r, m1 - 1, L_c)
            self.g_rows_acorr = tuple(float(t) for t in acr)
            self.g_cols_acorr = tuple(float(t) for t in acc)
            self.g_rows_taps = tuple(float(t) for t in us[:, 0])
            self.g_cols_taps = tuple(float(t) for t in vs[:, 0])
            dev = conv.device
            self.g_rows_E = None if Etr is None else (as_tensor(Etr, dev), as_tensor(Ebr, dev))
            self.g_cols_E = None if Etc is None else (as_tensor(Etc, dev), as_tensor(Ebc, dev))
            self._band_plans = (
                (as_tensor(acr.astype(np.float32), dev), *(self.g_rows_E or (None, None)), L_r),
                (as_tensor(acc.astype(np.float32), dev), *(self.g_cols_E or (None, None)), L_c),
            )

    def band_plans(self):
        """``(rows, cols)`` plans ``(acorr, E_top, E_bot, L)`` of the rank-1
        Gram for :func:`~pycsou_tpu_torch.kernels.band.gram_band_rows` and
        ``gram_band_cols``, on the device."""
        if self.g_meta is None:
            raise ValueError("the rank-1 plan needs a rank-1 PSF within the reference's gate")
        return self._band_plans

    @property
    def device(self):
        return self._device

    def apply(self, x):
        return sepgram2d(x, self.fwd, self.adj)

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))

    def grad_fused(self, x, atb):
        """Least-squares data gradient ``2 (A^H A x - atb)`` in one K2 pass
        (3 image streams)."""
        return sepgram2d(x, self.fwd, self.adj2, atb)
