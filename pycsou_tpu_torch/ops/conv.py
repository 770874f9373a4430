"""Convolutions (counterpart of ``pycsou_tpu/ops/conv.py``).

* ``Convolve2D`` -- 'same', zero-boundary convolution by four methods:
  ``'band'`` (a PSF of rank <= 4 within 31 taps per axis) runs apply and
  adjoint through kernel K1; ``'bandg'`` (rank 5-16 within 31 taps) runs
  them as the sum of one K1 launch per group of at most 4 factors;
  ``'fft'`` applies through ``torch.fft``; ``'direct'`` through
  ``F.conv2d`` at full f32.  The last two take the autodiff adjoint.
  ``svd_tol`` truncates an approximately low-rank PSF first.
* ``SeparableConvGram2D`` -- the exact Gram ``A^H A`` of a band convolution
  through kernel K2, and the fused least-squares gradient; for a rank-1
  PSF also the reference's rank-1 plan (``g_meta``, the autocorrelations,
  the raw taps and the edge corrections of ``kernels/band.py``), which the
  rank-1 TV engines K10-K12 read.
* ``ConvGram2D`` -- the exact FFT Gram of any other PSF (``ops/_gram.py``):
  one FFT round trip and thin boundary corrections in place of the four
  FFTs of ``A^H o A``.  A ``'bandg'`` convolution's Gram is the
  composition ``A^H o A`` of its grouped K1 sweeps.

* ``Convolve1D`` -- 'same' 1-D convolution, ``'direct'`` (``F.conv1d``),
  ``'fft'`` or ``'overlap-add'`` (chunks of a small FFT, each chunk's tail
  added into the next); ``ConvGram1D`` its exact Gram, the 2-D FFT Gram on
  a ``(1, n)`` view.  ``MovingAverage1D``/``MovingAverage2D`` are box
  filters (the 2-D one a band ``Convolve2D``: K1).
* ``ConvolveND`` -- 'same' N-D convolution through ``torch.fft``; its Gram
  is ``SeparableConvGramND`` (one band pass a axis) for a rank-1 filter,
  else the FFT Gram ``ConvGramND``.
* ``CircularConvolve`` -- periodic N-D convolution, diagonal in the DFT,
  with the exact Fourier ``pinv``.

None of these launches a kernel of the port except through ``Convolve2D``.
Adjoints are written out: the 'same' correlation is the convolution by the
flipped filter at the mirrored offset ``m - 1 - m // 2`` (``'direct'``,
``'overlap-add'``), or the product by ``conj(H)`` of the input placed at
its offset on the FFT grid (``'fft'``, ``ConvolveND``).

``lowrank_factors``, ``rank1_factors_nd`` and ``_fft_lipschitz`` are the
reference's numpy code unchanged, so the factor taps and ``||A||`` (hence
beta, tau and sigma) come out bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pycsou_tpu_torch.core.linop import LinearOperator, LinOpComp, SymmetricLinearOperator
from pycsou_tpu_torch.kernels.band import TILE, gram_band_axis, make_gram_band
from pycsou_tpu_torch.kernels.conv2d import MAX_RANK, MAX_TAPS, SepFactors, sepconv2d, sepgram2d
from pycsou_tpu_torch.utils.device import as_tensor, full_f32, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = [
    "Convolve1D",
    "Convolve2D",
    "ConvolveND",
    "CircularConvolve",
    "MovingAverage1D",
    "MovingAverage2D",
    "ConvGram1D",
    "ConvGram2D",
    "ConvGramND",
    "SeparableConvGram2D",
    "SeparableConvGramND",
    "lowrank_factors",
    "rank1_factors_nd",
    "next_fast_len",
]


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


def _real_filter(filt, cls: str) -> np.ndarray:
    """``filt`` (numpy or tensor) as a float32 numpy array; a complex
    filter raises."""
    filt_np = filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt)
    if np.iscomplexobj(filt_np):
        raise ValueError(f"{cls} takes real filters only")
    return filt_np.astype(np.float32)


def _fft_same(x, h_hat, s, offs, n):
    """'same' convolution on the FFT grid ``s``: the full convolution by the
    transfer ``h_hat``, cropped to ``n`` from ``offs``."""
    axes = tuple(range(len(s)))
    full = torch.fft.irfftn(torch.fft.rfftn(x, s=s, dim=axes) * h_hat, s=s, dim=axes)
    return full[tuple(slice(o, o + k) for o, k in zip(offs, n))]


def _fft_corr_same(y, h_hat, s, offs, n):
    """The adjoint of :func:`_fft_same`: ``y`` placed at ``offs`` on the
    grid ``s`` (zeros elsewhere), times ``conj(h_hat)``, cropped to the
    first ``n``.  Exact for ``s >= n + m - 1``: the correlation's wrap
    reads only the zero tail."""
    axes = tuple(range(len(s)))
    pad = [p for o, k, L in reversed(list(zip(offs, n, s))) for p in (o, L - k - o)]
    Y = torch.fft.rfftn(F.pad(y, pad), dim=axes)
    out = torch.fft.irfftn(Y * torch.conj(h_hat), s=s, dim=axes)
    return out[tuple(slice(0, k) for k in n)]


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


def _grouped_sweep_plans(filt_np: np.ndarray, device, max_rank: int = 16):
    """``(fwd, adj)`` factor stacks of a rank 5-``max_rank`` PSF within
    MAX_TAPS taps per axis, one pair per group of at most 4 factors (K1
    accumulates at most 4 ranks a pass), split as the reference splits them
    (``pycsou_tpu/ops/conv.py`` ``_grouped_sweep_plans``); None when the PSF
    does not qualify.  The reference's TPU tile gates (``W % 128 == 0``,
    ``W >= 384``, ``H % 8 == 0``) are not copied: K1 tiles any shape."""
    if max(filt_np.shape) > MAX_TAPS:
        return None
    fac = lowrank_factors(filt_np, max_rank=max_rank)
    if fac is None:
        return None
    us, vs = fac
    r = us.shape[1]
    if r <= MAX_RANK:
        return None
    m0, m1 = filt_np.shape
    groups = []
    for g0 in range(0, r, MAX_RANK):
        sl = slice(g0, min(g0 + MAX_RANK, r))
        fwd = SepFactors(us[:, sl], vs[:, sl], m0 // 2, m1 // 2, device)
        groups.append((fwd, fwd.adjoint()))
    return tuple(groups)


class Convolve2D(LinearOperator):
    """2-D 'same' convolution with a compact kernel, zero boundary:
    ``y[p] = sum_k h[k] x[p + o - k]`` with ``o = K // 2`` per axis.

    ``method='auto'`` takes the reference's pick for the device: ``'band'``
    when the PSF has rank <= 4 within 31 taps per axis, else ``'direct'``
    for at most 81 taps in all, else ``'fft'`` (the reference's CPU rule);
    on a CUDA device a PSF of rank 5-16 within 31 taps per axis then takes
    ``'bandg'`` (the reference's accelerator rule, without its TPU tile
    gates).

    ``svd_tol`` truncates the PSF's singular components ``sigma_i <= svd_tol
    * sigma_0`` first: the operator then is the truncated PSF, and
    ``svd_trunc_bound = ||h - h_trunc||_1`` bounds ``||A - A_trunc||_2``."""

    def __init__(self, dim_shape, filt, method: str = "auto", device=None, svd_tol: float = None):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 2:
            raise ValueError("Convolve2D expects a 2-D domain")
        dev = resolve_device(device, filt)
        filt_np = _real_filter(filt, "Convolve2D")
        if filt_np.ndim != 2:
            raise ValueError("filter must be 2-D")
        trunc_bound = 0.0
        if svd_tol is not None:
            f64 = np.asarray(filt_np, np.float64)
            U, S, Vt = np.linalg.svd(f64)
            keep = max(1, int(np.sum(S > float(svd_tol) * S[0])))
            f_t = (U[:, :keep] * S[:keep]) @ Vt[:keep]
            trunc_bound = float(np.abs(f64 - f_t).sum())
            filt_np = f_t.astype(np.float32)
        if method not in ("auto", "band", "bandg", "fft", "direct"):
            raise ValueError("method must be 'auto', 'band', 'bandg', 'fft' or 'direct'")
        fac = _band_factors(filt_np) if method in ("auto", "band") else None
        if method == "band" and fac is None:
            raise ValueError(f"kernel is not rank <= 4 within {MAX_TAPS} taps per axis")
        was_auto = method == "auto"
        if was_auto:
            method = "band" if fac is not None else ("direct" if filt_np.size <= 81 else "fft")
        groups = None
        if method == "bandg" or (was_auto and method != "band" and dev.type == "cuda"):
            groups = _grouped_sweep_plans(filt_np, dev)
            if groups is not None:
                method = "bandg"
            elif method == "bandg":
                raise ValueError(f"method='bandg' needs a PSF of rank 5-16 within {MAX_TAPS} taps per axis")
        padded = tuple(n + k - 1 for n, k in zip(dim_shape, filt_np.shape))
        super().__init__(dim_shape, dim_shape, lipschitz=_fft_lipschitz(filt_np, padded))
        self._device = dev
        self.filt = as_tensor(filt_np, dev)
        self.method = method
        self.svd_trunc_bound = trunc_bound
        self.factors = fac
        self.groups = groups
        self.fwd = self.adj = None
        self.h_hat = None
        if method == "band":
            m0, m1 = filt_np.shape
            self.fwd = SepFactors(fac[0], fac[1], m0 // 2, m1 // 2, dev)
            self.adj = self.fwd.adjoint()
        elif method == "fft":
            s = tuple(next_fast_len(n + k - 1) for n, k in zip(dim_shape, filt_np.shape))
            self.h_hat = torch.fft.rfft2(self.filt, s=s)

    @property
    def device(self):
        return self._device

    @property
    def batchable(self) -> bool:
        # 'band' and 'bandg' launch K1, which takes plain tensors, not vmap's
        return self.method not in ("band", "bandg")

    def apply(self, x):
        if self.method == "band":
            return sepconv2d(x, self.fwd)
        if self.method == "bandg":
            return _group_sum(x, (fwd for fwd, _ in self.groups))
        (n0, n1), (m0, m1) = self.dim_shape, self.filt.shape
        o0, o1 = m0 // 2, m1 // 2
        if self.method == "fft":
            s = (next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1))
            full = torch.fft.irfft2(torch.fft.rfft2(x, s=s) * self.h_hat, s=s)
            return full[o0 : o0 + n0, o1 : o1 + n1]
        # 'direct': F.conv2d correlates, so the taps are flipped and the
        # padding is m - 1 - o before and o after (asymmetric for even m)
        with full_f32():
            out = F.conv2d(F.pad(x[None, None], (m1 - 1 - o1, o1, m0 - 1 - o0, o0)),
                           self.filt.flip((0, 1))[None, None])
        return out[0, 0]

    def adjoint(self, y):
        y = torch.as_tensor(y)
        if self.method == "band":
            return sepconv2d(y, self.adj)
        if self.method == "bandg":
            return _group_sum(y, (adj for _, adj in self.groups))
        # the VJP of apply; its backward convolution at full f32 as well
        with full_f32():
            return super().adjoint(y)

    @property
    def gram(self):
        """Exact ``A^H A``: the fused K2 Gram of a band convolution, the
        composition ``A^H o A`` of the grouped K1 sweeps of a ``'bandg'``
        one, else the FFT Gram :class:`ConvGram2D`."""
        if self.method == "band":
            return SeparableConvGram2D(self)
        if self.method == "bandg":
            return SymmetricLinearOperator(LinOpComp(self.H, self))
        return ConvGram2D(self)


def _group_sum(x, stacks) -> torch.Tensor:
    """``sum_g K1(x, stack_g)``: one K1 launch per factor group."""
    out = None
    for f in stacks:
        t = sepconv2d(x, f)
        out = t if out is None else out + t
    return out


class ConvGram2D(LinearOperator):
    """Exact Gram of a 'same' 2-D convolution (self-adjoint, PSD) through
    the FFT (``ops/_gram.py``), with the transfers cached on the
    convolution's device.  Two equivalent paths:

    * ``wrap`` -- the circular Gram at exactly the image size plus the
      wraparound-band corrections; ``"auto"`` takes it when both image dims
      are fast FFT sizes (:func:`next_fast_len`) and at least 4 m, with no
      ``fft_shape``;
    * padded -- the FFT at ``next_fast_len(n + 2m - 2)`` (or ``fft_shape``)
      with the frame corrections."""

    def __init__(self, conv: Convolve2D, fft_shape=None, wrap="auto"):
        from pycsou_tpu_torch.ops._gram import (
            make_conv2d_gram, make_conv2d_gram_wrap, make_pad_cache, make_wrap_cache,
        )

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2)
        self._device = conv.device
        self.filt = conv.filt
        (n0, n1), (m0, m1) = conv.dim_shape, tuple(conv.filt.shape)
        if wrap == "auto":
            use_wrap = (fft_shape is None and next_fast_len(n0) == n0 and next_fast_len(n1) == n1
                        and n0 >= 4 * m0 and n1 >= 4 * m1)
        else:
            use_wrap = bool(wrap)
            if use_wrap and (n0 < 2 * m0 - 1 or n1 < 2 * m1 - 1):
                # the wraparound bands must hold the full unwrapped reach;
                # a smaller image would give a wrong Gram
                raise ValueError(
                    f"wrap=True needs n >= 2m-1 per axis; got image {conv.dim_shape} "
                    f"for kernel {tuple(conv.filt.shape)}"
                )
        self.wrap = use_wrap
        if use_wrap:
            self.h2_hat = make_conv2d_gram_wrap(conv.dim_shape, self.filt)
            self.cache = make_wrap_cache(conv.dim_shape, self.filt)
            self.L = tuple(conv.dim_shape)
        else:
            self.h2_hat, self.L = make_conv2d_gram(conv.dim_shape, self.filt, fft_shape=fft_shape)
            self.cache = make_pad_cache(conv.dim_shape, self.filt)

    @property
    def device(self):
        return self._device

    def apply(self, x):
        from pycsou_tpu_torch.ops._gram import conv2d_gram_apply, conv2d_gram_apply_wrap

        if self.wrap:
            return conv2d_gram_apply_wrap(x, self.filt, self.h2_hat, cache=self.cache)
        return conv2d_gram_apply(x, self.filt, self.h2_hat, self.L, cache=self.cache)

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))


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

    batchable = False  # apply launches K2, which takes plain tensors, not vmap's

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


# -- 1-D ------------------------------------------------------------------------


def _direct1d(x, w, pad) -> torch.Tensor:
    """``F.conv1d`` (a correlation) of ``x`` by the taps ``w`` after zero
    padding ``pad``, at full f32."""
    with full_f32():
        return F.conv1d(F.pad(x[None, None], pad), w[None, None])[0, 0]


def _overlap_add(x, h_hat, nfft: int, m: int, ofs: int) -> torch.Tensor:
    """'same' convolution (offset ``ofs``) of ``x`` by an m-tap filter of
    transfer ``h_hat = rfft(h, nfft)``: ``nfft - (m - 1)``-sample chunks
    convolved by one batched rfft/irfft, each chunk's (m - 1)-sample tail
    added into the next, the last tail appended."""
    n = x.shape[-1]
    L = nfft - (m - 1)
    nb = -(-n // L)
    xp = F.pad(x, (0, nb * L - n)).reshape(nb, L)
    chunks = torch.fft.irfft(torch.fft.rfft(xp, n=nfft, dim=1) * h_hat, n=nfft, dim=1)
    full = chunks[:, :L]
    if m > 1:
        tails = chunks[:, L:]
        carry = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])
        full = torch.cat([full[:, : m - 1] + carry, full[:, m - 1 :]], dim=1)
        full = torch.cat([full.reshape(-1), tails[-1]])
    else:
        full = full.reshape(-1)
    return full[ofs : ofs + n]


class Convolve1D(LinearOperator):
    """1-D 'same' convolution, zero boundary: ``y[i] = sum_k h[k] x[i - k +
    o]`` with ``o = m // 2``.

    ``method='auto'`` is the reference's rule: ``'direct'`` up to 32 taps,
    ``'overlap-add'`` for ``n >= 2**18`` and ``8 m <= n``, else ``'fft'``
    (on ``next_fast_len(n + m - 1)``, the transfer computed once).
    ``'overlap-add'`` takes chunks of ``next_fast_len(max(8 m, 256))``.  The
    Gram is :class:`ConvGram1D`."""

    def __init__(self, dim_shape, filt, method: str = "auto", device=None):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 1:
            raise ValueError("Convolve1D expects a 1-D domain")
        dev = resolve_device(device, filt)
        filt_np = _real_filter(filt, "Convolve1D")
        if filt_np.ndim != 1:
            raise ValueError("filter must be 1-D")
        n, m = dim_shape[0], filt_np.shape[0]
        if method == "auto":
            if m <= 32:
                method = "direct"
            elif n >= 1 << 18 and m * 8 <= n:
                method = "overlap-add"
            else:
                method = "fft"
        if method not in ("fft", "direct", "overlap-add"):
            raise ValueError("method must be 'auto', 'fft', 'direct' or 'overlap-add'")
        super().__init__(dim_shape, dim_shape, lipschitz=_fft_lipschitz(filt_np, (n + m - 1,)))
        self._device = dev
        self.filt = as_tensor(filt_np, dev)
        self.method = method
        self.h_hat = self.h_hat_adj = None
        if method == "fft":
            self.h_hat = torch.fft.rfft(self.filt, n=next_fast_len(n + m - 1))
        elif method == "overlap-add":
            self.h_hat = torch.fft.rfft(self.filt, n=self._oa_nfft())
            self.h_hat_adj = torch.fft.rfft(self.filt.flip(0), n=self._oa_nfft())

    def _oa_nfft(self) -> int:
        """Overlap-add's chunk FFT size: well above the filter, so that a
        chunk's (m - 1)-sample tail fits in the next chunk."""
        return next_fast_len(max(8 * self.filt.shape[0], 256))

    @property
    def device(self):
        return self._device

    def apply(self, x):
        n, m = self.dim_shape[0], self.filt.shape[0]
        o = m // 2
        if self.method == "fft":
            return _fft_same(x, self.h_hat, (next_fast_len(n + m - 1),), (o,), (n,))
        if self.method == "overlap-add":
            return _overlap_add(x, self.h_hat, self._oa_nfft(), m, o)
        return _direct1d(x, self.filt.flip(0), (m - 1 - o, o))

    def adjoint(self, y):
        y = torch.as_tensor(y)
        n, m = self.dim_shape[0], self.filt.shape[0]
        o = m // 2
        if self.method == "fft":
            return _fft_corr_same(y, self.h_hat, (next_fast_len(n + m - 1),), (o,), (n,))
        if self.method == "overlap-add":
            return _overlap_add(y, self.h_hat_adj, self._oa_nfft(), m, m - 1 - o)
        return _direct1d(y, self.filt, (o, m - 1 - o))

    @property
    def gram(self):
        """The exact ``A^H A``: :class:`ConvGram1D`."""
        return ConvGram1D(self)


class ConvGram1D(LinearOperator):
    """Exact Gram of a 'same' 1-D convolution: the 2-D FFT Gram
    (``ops/_gram.py`` ``conv2d_gram_apply``, its transfers cached) on a
    ``(1, n)`` view."""

    def __init__(self, conv: Convolve1D):
        from pycsou_tpu_torch.ops._gram import make_conv2d_gram, make_pad_cache

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2)
        self._device = conv.device
        shape2d = (1, conv.dim_shape[0])
        self.filt = conv.filt[None, :]
        self.h2_hat, self.L = make_conv2d_gram(shape2d, self.filt)
        self.cache = make_pad_cache(shape2d, self.filt)

    @property
    def device(self):
        return self._device

    def apply(self, x):
        from pycsou_tpu_torch.ops._gram import conv2d_gram_apply

        return conv2d_gram_apply(x[None, :], self.filt, self.h2_hat, self.L, cache=self.cache)[0]

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))


def MovingAverage1D(dim_shape, window: int, device=None) -> Convolve1D:
    """Length-``window`` box filter (a ``Convolve1D``)."""
    return Convolve1D(dim_shape, np.ones((window,), np.float32) / window, device=device)


def MovingAverage2D(dim_shape, window: Tuple[int, int], device=None) -> Convolve2D:
    """``w0 x w1`` box filter: a rank-1 ``Convolve2D``, so ``'band'`` (K1)."""
    w0, w1 = window
    return Convolve2D(dim_shape, np.ones((w0, w1), np.float32) / (w0 * w1), device=device)


# -- N-D ------------------------------------------------------------------------


def rank1_factors_nd(filt_np: np.ndarray, tol: float = 1e-6):
    """Per-axis factors ``[u_0, ..., u_{d-1}]`` (float64) with ``filt = u_0
    (x) ... (x) u_{d-1}``, or None when the filter is not rank-1 to relative
    accuracy ``tol`` (the reference's numpy)."""
    filt = np.asarray(filt_np, np.float64)
    nd = filt.ndim
    us = []
    for k in range(nd):
        unf = np.moveaxis(filt, k, 0).reshape(filt.shape[k], -1)
        U, S, Vt = np.linalg.svd(unf, full_matrices=False)
        us.append(U[:, 0])
    # scale: project filt onto the rank-1 tensor
    outer = us[0]
    for u in us[1:]:
        outer = np.multiply.outer(outer, u)
    s = float(np.vdot(outer, filt))
    approx = s * outer
    if np.linalg.norm(approx - filt) > tol * max(np.linalg.norm(filt), 1e-30):
        return None
    us[0] = us[0] * s
    return [u.astype(np.float64) for u in us]


class ConvolveND(LinearOperator):
    """N-D 'same' convolution (offset ``m // 2`` per axis), zero boundary,
    through ``torch.fft`` on ``next_fast_len(n + m - 1)`` per axis with the
    transfer computed once.  Its Gram is :class:`SeparableConvGramND` for a
    rank-1 filter within the gates of its ``build``, else
    :class:`ConvGramND`."""

    def __init__(self, dim_shape, filt, device=None):
        dim_shape = as_shape(dim_shape)
        dev = resolve_device(device, filt)
        filt_np = _real_filter(filt, "ConvolveND")
        if filt_np.ndim != len(dim_shape):
            raise ValueError("filter rank must match the domain rank")
        padded = tuple(n + k - 1 for n, k in zip(dim_shape, filt_np.shape))
        super().__init__(dim_shape, dim_shape, lipschitz=_fft_lipschitz(filt_np, padded))
        self._device = dev
        self.filt = as_tensor(filt_np, dev)
        self._s = tuple(next_fast_len(p) for p in padded)
        self._offs = tuple(k // 2 for k in filt_np.shape)
        self.h_hat = torch.fft.rfftn(self.filt, s=self._s, dim=tuple(range(len(dim_shape))))

    @property
    def device(self):
        return self._device

    def apply(self, x):
        return _fft_same(x, self.h_hat, self._s, self._offs, self.dim_shape)

    def adjoint(self, y):
        return _fft_corr_same(torch.as_tensor(y), self.h_hat, self._s, self._offs, self.dim_shape)

    @property
    def gram(self):
        """The exact ``A^H A``: one band pass a axis for a rank-1 filter
        (:class:`SeparableConvGramND`), else one rfftn round trip and the
        slab corrections (:class:`ConvGramND`)."""
        g = SeparableConvGramND.build(self)
        return g if g is not None else ConvGramND(self)


class ConvGramND(LinearOperator):
    """Exact Gram of a 'same' N-D convolution (``ops/_gram.py``
    ``convnd_gram_apply``, the transfers cached on the device)."""

    def __init__(self, conv: ConvolveND):
        from pycsou_tpu_torch.ops._gram import make_convnd_cache, make_convnd_gram

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2)
        self._device = conv.device
        self.filt = conv.filt
        self.h2_hat, self.L = make_convnd_gram(conv.dim_shape, self.filt)
        self.cache = make_convnd_cache(conv.dim_shape, self.filt)

    @property
    def device(self):
        return self._device

    def apply(self, x):
        from pycsou_tpu_torch.ops._gram import convnd_gram_apply

        return convnd_gram_apply(x, self.filt, self.h2_hat, self.L, cache=self.cache)

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))


class SeparableConvGramND(LinearOperator):
    """Exact Gram of a 'same' N-D convolution by a rank-1 filter ``u_0 (x)
    ... (x) u_{d-1}``: the per-axis 1-D Grams composed, each one band pass
    of 2K - 1 taps and its two edge corrections
    (``kernels/band.py`` :func:`gram_band_axis`), no FFT."""

    @staticmethod
    def build(conv: ConvolveND, tol: float = 1e-6):
        """The Gram when the reference takes it, else None: a real filter,
        ``2 (m - 1) <= TILE`` and ``n >= 3 m`` on every axis, rank 1 to
        ``tol``."""
        if conv.dtype.is_complex:
            return None
        filt = conv.filt.detach().cpu().numpy()
        if any(2 * (m - 1) > TILE for m in filt.shape):
            return None
        if any(n < 3 * m for n, m in zip(conv.dim_shape, filt.shape)):
            return None
        us = rank1_factors_nd(filt, tol=tol)
        if us is None:
            return None
        return SeparableConvGramND(conv, us)

    def __init__(self, conv: ConvolveND, factors):
        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2)
        dev = self._device = conv.device
        plans = []
        for u, n in zip(factors, conv.dim_shape):
            acorr, Et, Eb, L = make_gram_band(u, int(n))
            E = (None, None) if Et is None else (as_tensor(Et, dev), as_tensor(Eb, dev))
            plans.append((as_tensor(acorr.astype(np.float32), dev), *E, L))
        self.g_plans = tuple(plans)

    @property
    def device(self):
        return self._device

    def apply(self, x):
        for ax, plan in enumerate(self.g_plans):
            x = gram_band_axis(x, plan, ax)
        return x

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))


class CircularConvolve(LinearOperator):
    """Periodic N-D convolution ``A = F^H diag(H) F``: the filter zero-padded
    to the domain and rolled by ``-(k // 2)`` per axis ('same'-aligned),
    then ``rfftn``; or ``h_hat`` (complex, the rfftn layout) given.
    ``lipschitz = max |H|``, and ``pinv`` is the exact (damped) Fourier
    inverse."""

    def __init__(self, dim_shape, filt=None, h_hat=None, device=None):
        dim_shape = as_shape(dim_shape)
        axes = tuple(range(len(dim_shape)))
        if h_hat is None:
            if filt is None:
                raise ValueError("pass filt or h_hat")
            dev = resolve_device(device, filt)
            f = as_tensor(_real_filter(filt, "CircularConvolve"), dev)
            if f.ndim != len(dim_shape):
                raise ValueError("filter rank must match the domain rank")
            hfull = F.pad(f, [p for n, k in reversed(list(zip(dim_shape, f.shape))) for p in (0, n - k)])
            hfull = torch.roll(hfull, tuple(-(k // 2) for k in f.shape), dims=axes)
            h_hat = torch.fft.rfftn(hfull, dim=axes)
        else:
            dev = resolve_device(device, h_hat)
            h_hat = as_tensor(h_hat, dev, torch.complex64)
            want = dim_shape[:-1] + (dim_shape[-1] // 2 + 1,)
            if tuple(h_hat.shape) != want:
                raise ValueError(f"h_hat must have the rfftn shape {want}, got {tuple(h_hat.shape)}")
        hh = h_hat.detach().cpu().numpy()
        # the reference's max |H| from the float32 parts
        super().__init__(dim_shape, dim_shape, lipschitz=float(np.max(np.hypot(hh.real, hh.imag))))
        self._device = dev
        self.h_hat = h_hat

    @property
    def device(self):
        return self._device

    def _axes(self):
        return tuple(range(len(self.dim_shape)))

    def apply(self, x):
        X = torch.fft.rfftn(x, dim=self._axes())
        return torch.fft.irfftn(X * self.h_hat, s=self.dim_shape, dim=self._axes())

    def adjoint(self, y):
        Y = torch.fft.rfftn(torch.as_tensor(y), dim=self._axes())
        return torch.fft.irfftn(Y * torch.conj(self.h_hat), s=self.dim_shape, dim=self._axes())

    def pinv(self, y, damp: float = 0.0, **kwargs):
        """Exact (damped) inverse in the Fourier domain: ``conj(H) Y /
        max(|H|^2 + damp, 1e-30)``."""
        Y = torch.fft.rfftn(torch.as_tensor(y), dim=self._axes())
        denom = torch.abs(self.h_hat) ** 2 + damp
        X = Y * torch.conj(self.h_hat) / torch.clamp(denom, min=1e-30)
        return torch.fft.irfftn(X, s=self.dim_shape, dim=self._axes())
