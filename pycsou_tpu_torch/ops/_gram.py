"""Exact FFT Gram of a 'same' 2-D and N-D convolution (counterpart of
``pycsou_tpu/ops/_gram.py``).

For ``A = S o conv_full(h) o P`` ('same' linear convolution, zero boundary)

    A^H A x = irfft(|H|^2 rfft(x))[:n]  -  A_full^T((I - S^T S) A_full x)

The first term, the Gram of the full convolution, is exact for an FFT size
``L >= n + 2m - 2`` per axis and costs one rfft/irfft round trip; the
correction involves only thin frame strips of about the kernel's width,
convolved by small FFTs.  The wrap path (:func:`conv2d_gram_apply_wrap`)
takes the FFT at exactly the image size and subtracts the wraparound terms,
confined to ``(m - 1)``-wide bands, before the frame corrections.

The N-D Gram (:func:`convnd_gram_apply`) is one ``rfftn``/``irfftn`` round
trip minus 2d disjoint boundary slabs: the slabs of axis j are restricted
to the valid window on every axis before j.

The kernel transfers are computed once (:func:`make_pad_cache`,
:func:`make_wrap_cache`, :func:`make_convnd_cache`) as complex tensors on
the filter's device, so an apply spends FFTs only on data.  The corrections add into the result the
apply itself allocated; the input is never written.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pycsou_tpu_torch.ops.conv import next_fast_len

__all__ = [
    "conv_full_direct",
    "full_transfer",
    "make_pad_cache",
    "conv2d_gram_apply",
    "make_wrap_cache",
    "conv2d_gram_apply_wrap",
    "make_conv2d_gram_wrap",
    "make_conv2d_gram",
    "make_convnd_gram",
    "make_convnd_cache",
    "convnd_gram_apply",
]


def conv_full_direct(a: torch.Tensor, h: torch.Tensor, h_hat=None) -> torch.Tensor:
    """'full'-mode 2-D convolution of a thin strip ``a`` by ``h`` through
    small rFFTs.  Pass ``h_hat`` (from :func:`full_transfer` for the same
    strip shape) to skip the kernel's FFT; ``h`` then gives only its shape."""
    a0, a1 = a.shape
    m0, m1 = h.shape
    f0, f1 = a0 + m0 - 1, a1 + m1 - 1
    s = (next_fast_len(f0), next_fast_len(f1))
    A = torch.fft.rfft2(a, s=s)
    H = torch.fft.rfft2(h, s=s) if h_hat is None else h_hat
    return torch.fft.irfft2(A * H, s=s)[:f0, :f1]


def full_transfer(h: torch.Tensor, slab_shape: Tuple[int, int]) -> torch.Tensor:
    """The kernel rFFT :func:`conv_full_direct` uses for strips of
    ``slab_shape``."""
    s = (next_fast_len(slab_shape[0] + h.shape[0] - 1), next_fast_len(slab_shape[1] + h.shape[1] - 1))
    return torch.fft.rfft2(h, s=s)


def _corr_into(out, strip, h, row_off: int, col_off: int, c_hat=None):
    """Subtract ``A_full^T`` of a strip at full-grid offset (row_off,
    col_off) from ``out``, the n-sized result the caller allocated.  The
    correlation is the convolution with the flipped kernel, shifted by
    m - 1; the part of it outside the image is clipped."""
    m0, m1 = h.shape
    n0, n1 = out.shape
    c = conv_full_direct(strip, h.flip((0, 1)) if c_hat is None else h, h_hat=c_hat)
    # c's index q is the output index j = q + off - (m - 1)
    j0_lo = row_off - (m0 - 1)
    j1_lo = col_off - (m1 - 1)
    q0_lo = max(0, -j0_lo)
    q1_lo = max(0, -j1_lo)
    j0_start = max(0, j0_lo)
    j1_start = max(0, j1_lo)
    q0_hi = min(c.shape[0], n0 - j0_lo)
    q1_hi = min(c.shape[1], n1 - j1_lo)
    if q0_hi <= q0_lo or q1_hi <= q1_lo:
        return out
    out[j0_start : j0_start + (q0_hi - q0_lo), j1_start : j1_start + (q1_hi - q1_lo)] -= c[q0_lo:q0_hi, q1_lo:q1_hi]
    return out


def make_pad_cache(dim_shape: Tuple[int, int], filt: torch.Tensor) -> dict:
    """The kernel transfers of :func:`conv2d_gram_apply`'s frame
    corrections, on ``filt``'s device."""
    n0, n1 = dim_shape
    m0, m1 = filt.shape
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    f = filt.flip((0, 1))
    cache = {}
    if o0 > 0:
        cache["frame_top_h"] = full_transfer(filt, (min(o0, n0), n1))
        cache["frame_top_c"] = full_transfer(f, (o0, n1 + m1 - 1))
    if b0 > 0:
        start0 = max(0, n0 - (m0 - 1))
        cache["frame_bot_h"] = full_transfer(filt, (n0 - start0, n1))
        cache["frame_bot_c"] = full_transfer(f, (b0, n1 + m1 - 1))
    if o1 > 0:
        cache["frame_left_h"] = full_transfer(filt, (n0, min(o1, n1)))
        cache["frame_left_c"] = full_transfer(f, (n0, o1))
    if b1 > 0:
        start1 = max(0, n1 - (m1 - 1))
        cache["frame_right_h"] = full_transfer(filt, (n0, n1 - start1))
        cache["frame_right_c"] = full_transfer(f, (n0, b1))
    return cache


def _frame_corrections(g, x, filt, cache, top_rows: int):
    """Subtract the 'same' crop's frame terms ``A_full^T((I - S^T S)
    A_full x)`` from ``g``: the top slab convolves ``x[:top_rows]``
    (``o0`` rows on the padded path, ``m0`` on the wrap path, each with its
    cached transfer)."""
    n0, n1 = x.shape
    m0, m1 = filt.shape
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    h = filt
    if o0 > 0:
        top = conv_full_direct(x[:top_rows], h, h_hat=cache.get("frame_top_h"))[:o0]
        g = _corr_into(g, top, h, row_off=0, col_off=0, c_hat=cache.get("frame_top_c"))
    if b0 > 0:
        # clamped slab start (n0 may be < m0 - 1): local row r of the full
        # conv is global full row start0 + r; the rows [o0 + n0, n0 + m0 - 1)
        start0 = max(0, n0 - (m0 - 1))
        cb = conv_full_direct(x[start0:], h, h_hat=cache.get("frame_bot_h"))
        r_lo = (o0 + n0) - start0
        g = _corr_into(g, cb[r_lo : r_lo + b0], h, row_off=o0 + n0, col_off=0, c_hat=cache.get("frame_bot_c"))
    if o1 > 0:
        ml = conv_full_direct(x[:, :o1], h, h_hat=cache.get("frame_left_h"))[o0 : o0 + n0, :o1]
        g = _corr_into(g, ml, h, row_off=o0, col_off=0, c_hat=cache.get("frame_left_c"))
    if b1 > 0:
        start1 = max(0, n1 - (m1 - 1))
        cr = conv_full_direct(x[:, start1:], h, h_hat=cache.get("frame_right_h"))
        c_lo = (o1 + n1) - start1
        mr = cr[o0 : o0 + n0, c_lo : c_lo + b1]
        g = _corr_into(g, mr, h, row_off=o0, col_off=o1 + n1, c_hat=cache.get("frame_right_c"))
    return g


def conv2d_gram_apply(x: torch.Tensor, filt: torch.Tensor, h2_hat: torch.Tensor, L: Tuple[int, int],
                      cache: dict = None) -> torch.Tensor:
    """Exact ``A^H A x`` of the 'same' 2-D convolution (centre offset
    m // 2).  ``h2_hat = |rfft2(filt, L)|^2`` with ``L >= n + 2m - 2`` per
    axis (:func:`make_conv2d_gram`); ``cache`` from :func:`make_pad_cache`
    skips the kernel transfers of the frame corrections."""
    n0, n1 = x.shape
    # the main term: the Gram of the full (uncropped) convolution
    g = torch.fft.irfft2(torch.fft.rfft2(x, s=L) * h2_hat, s=L)[:n0, :n1]
    return _frame_corrections(g, x, filt, cache or {}, top_rows=filt.shape[0] // 2)


def _conv_rowlin_colcirc(slab: torch.Tensor, a: torch.Tensor, n_cols: int, a_hat=None) -> torch.Tensor:
    """Convolution of a thin slab by ``a``, linear along rows (full mode),
    circular along columns at period ``n_cols``: ``slab_rows + a_rows - 1``
    rows of ``n_cols`` columns."""
    r = slab.shape[0] + a.shape[0] - 1
    s = (next_fast_len(r), n_cols)  # the exact column length: a circular wrap
    S = torch.fft.rfft2(slab, s=s)
    A = torch.fft.rfft2(a, s=s) if a_hat is None else a_hat
    return torch.fft.irfft2(S * A, s=s)[:r]


def _conv_collin_rowcirc(slab: torch.Tensor, a: torch.Tensor, n_rows: int, a_hat=None) -> torch.Tensor:
    """The transposed variant: circular along rows (period ``n_rows``),
    linear along columns."""
    c = slab.shape[1] + a.shape[1] - 1
    s = (n_rows, next_fast_len(c))
    S = torch.fft.rfft2(slab, s=s)
    A = torch.fft.rfft2(a, s=s) if a_hat is None else a_hat
    return torch.fft.irfft2(S * A, s=s)[:, :c]


def make_wrap_cache(dim_shape: Tuple[int, int], filt: torch.Tensor) -> dict:
    """Every kernel transfer :func:`conv2d_gram_apply_wrap` uses (and the
    autocorrelation ``a``), on ``filt``'s device."""
    n0, n1 = dim_shape
    m0, m1 = filt.shape
    p0, p1 = m0 - 1, m1 - 1
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    f = filt.flip((0, 1))
    a = conv_full_direct(filt, f)
    cache = {"a": a}
    if p0 > 0:
        cache["band_row"] = torch.fft.rfft2(a, s=(next_fast_len(p0 + 2 * p0), n1))
    if p1 > 0:
        cache["band_col"] = torch.fft.rfft2(a, s=(n0, next_fast_len(p1 + 2 * p1)))
    if p0 > 0 and p1 > 0:
        cache["corner"] = full_transfer(a, (p0, p1))
    if o0 > 0:
        cache["frame_top_h"] = full_transfer(filt, (m0, n1))
        cache["frame_top_c"] = full_transfer(f, (o0, n1 + m1 - 1))
    if b0 > 0:
        cache["frame_bot_h"] = full_transfer(filt, (m0 - 1, n1))
        cache["frame_bot_c"] = full_transfer(f, (b0, n1 + m1 - 1))
    if o1 > 0:
        cache["frame_left_h"] = full_transfer(filt, (n0, o1))
        cache["frame_left_c"] = full_transfer(f, (n0, o1))
    if b1 > 0:
        cache["frame_right_h"] = full_transfer(filt, (n0, m1 - 1))
        cache["frame_right_c"] = full_transfer(f, (n0, b1))
    return cache


def conv2d_gram_apply_wrap(x: torch.Tensor, filt: torch.Tensor, h2_hat: torch.Tensor,
                           cache: dict = None) -> torch.Tensor:
    """Exact ``A^H A x`` with the FFT at exactly the image size (image dims
    that are fast FFT sizes, at least ``2m - 1``).

    The circular Gram ``irfft(|rfft(h, n)|^2 rfft(x))`` is the full-conv
    Gram plus wraparound terms confined to (m - 1)-wide boundary bands;
    those are subtracted with thin-slab convolutions (circular along the
    axis that does not wrap), then the frame corrections of
    :func:`conv2d_gram_apply` are subtracted on top."""
    n0, n1 = x.shape
    m0, m1 = filt.shape
    p0, p1 = m0 - 1, m1 - 1
    cache = cache or {}
    a = cache.get("a")
    if a is None:
        a = conv_full_direct(filt, filt.flip((0, 1)))  # the autocorrelation, (2 m0 - 1, 2 m1 - 1)

    g = torch.fft.irfft2(torch.fft.rfft2(x) * h2_hat, s=(n0, n1))

    # -- the row-wraparound terms (columns circular, as in g) --------------
    # slab row u = (x row) - slab offset; conv row t = u + s0 (s0 = d0 + p0)
    # collapses to an index free of d0 (see each slice).  The circular axis
    # of the helper is shifted by its kernel's half width (output column j1
    # lives at (j1 + p1) mod n1), hence the rolls.
    if p0 > 0:
        # top rows j0 in [0, p0): terms a[d0 > j0] x[j0 - d0 + n0] from the
        # bottom slab; t = (j0 - d0 + p0) + (d0 + p0) = j0 + 2 p0
        ct = _conv_rowlin_colcirc(x[n0 - p0 :], a, n1, a_hat=cache.get("band_row"))
        g[:p0] -= torch.roll(ct[2 * p0 : 3 * p0], -p1, dims=1)
        # bottom rows j0 in [n0 - p0, n0): terms a[d0 <= j0 - n0] x[j0 - d0 - n0]
        # from the top slab; t = j0 - n0 + p0 in [0, p0)
        cb = _conv_rowlin_colcirc(x[:p0], a, n1, a_hat=cache.get("band_row"))
        g[n0 - p0 :] -= torch.roll(cb[:p0], -p1, dims=1)
    # -- the column-wraparound terms (rows circular) -----------------------
    if p1 > 0:
        cl = _conv_collin_rowcirc(x[:, n1 - p1 :], a, n0, a_hat=cache.get("band_col"))
        g[:, :p1] -= torch.roll(cl[:, 2 * p1 : 3 * p1], -p0, dims=0)
        cr = _conv_collin_rowcirc(x[:, :p1], a, n0, a_hat=cache.get("band_col"))
        g[:, n1 - p1 :] -= torch.roll(cr[:, :p1], -p0, dims=0)
    # -- add back the doubly wrapped (corner) terms, subtracted twice ------
    if p0 > 0 and p1 > 0:
        for rows, r_out, r_sl in ((slice(n0 - p0, n0), slice(0, p0), slice(2 * p0, 3 * p0)),
                                  (slice(0, p0), slice(n0 - p0, n0), slice(0, p0))):
            for cols, c_out, c_sl in ((slice(n1 - p1, n1), slice(0, p1), slice(2 * p1, 3 * p1)),
                                      (slice(0, p1), slice(n1 - p1, n1), slice(0, p1))):
                cc = conv_full_direct(x[rows, cols], a, h_hat=cache.get("corner"))
                g[r_out, c_out] += cc[r_sl, c_sl]

    # -- finally the 'same' crop's frame corrections -----------------------
    return _frame_corrections(g, x, filt, cache, top_rows=m0)


def make_conv2d_gram_wrap(dim_shape: Tuple[int, int], filt: torch.Tensor) -> torch.Tensor:
    """``|rfft2(h, n)|^2`` for the exact-size (wraparound-corrected) path."""
    H = torch.fft.rfft2(filt, s=tuple(dim_shape))
    return (H * torch.conj(H)).real


def make_conv2d_gram(dim_shape: Tuple[int, int], filt: torch.Tensor, fft_shape: Tuple[int, int] = None):
    """``(h2_hat, L)`` for :func:`conv2d_gram_apply`.  ``fft_shape`` may set
    the FFT size (at least ``n + 2m - 2`` per axis)."""
    n0, n1 = dim_shape
    m0, m1 = filt.shape
    if fft_shape is None:
        L = (next_fast_len(n0 + 2 * m0 - 2), next_fast_len(n1 + 2 * m1 - 2))
    else:
        L = tuple(int(s) for s in fft_shape)
        if L[0] < n0 + 2 * m0 - 2 or L[1] < n1 + 2 * m1 - 2:
            raise ValueError("fft_shape must be >= n + 2m - 2 per axis")
    H = torch.fft.rfft2(filt, s=L)
    return (H * torch.conj(H)).real, L


# -- N-D: one rfftn round trip and the boundary slabs --------------------------


def _conv_full_nd(a: torch.Tensor, h: torch.Tensor, h_hat=None) -> torch.Tensor:
    """'full'-mode N-D convolution of a thin slab ``a`` by ``h`` through
    small rFFTs; ``h_hat`` (from :func:`make_convnd_cache`) skips the
    kernel's FFT."""
    full = tuple(sa + sh - 1 for sa, sh in zip(a.shape, h.shape))
    s = tuple(next_fast_len(f) for f in full)
    axes = tuple(range(a.ndim))
    H = torch.fft.rfftn(h, s=s, dim=axes) if h_hat is None else h_hat
    out = torch.fft.irfftn(torch.fft.rfftn(a, s=s, dim=axes) * H, s=s, dim=axes)
    return out[tuple(slice(0, f) for f in full)]


def _corr_into_nd(out, strip, h, offs, c_hat=None):
    """Subtract ``A_full^T`` of a slab at full-grid offset ``offs`` from
    ``out``, the n-sized result the caller allocated (the N-D
    :func:`_corr_into`); ``c_hat`` is the flipped kernel's transfer."""
    c = _conv_full_nd(strip, h.flip(tuple(range(h.ndim))) if c_hat is None else h, h_hat=c_hat)
    sl_out, sl_c = [], []
    for d in range(out.ndim):
        j_lo = offs[d] - (h.shape[d] - 1)
        q_lo = max(0, -j_lo)
        j_start = max(0, j_lo)
        q_hi = min(c.shape[d], out.shape[d] - j_lo)
        if q_hi <= q_lo:
            return out
        sl_c.append(slice(q_lo, q_hi))
        sl_out.append(slice(j_start, j_start + (q_hi - q_lo)))
    out[tuple(sl_out)] -= c[tuple(sl_c)]
    return out


def _slab_plan(n: Tuple[int, ...], m: Tuple[int, ...]):
    """The boundary slabs of the N-D Gram: for each axis j and side with a
    frame (``o_j > 0`` low, ``b_j > 0`` high), ``(j, sl_in, sel, offs)``:
    the input slab's slice along j, the conv output's restriction (axes
    before j to the valid window ``[o_d, o_d + n_d)``, axis j to the frame
    rows, axes after j whole) and the strip's full-grid offsets."""
    nd = len(n)
    o = tuple(mk // 2 for mk in m)
    b = tuple(mk - 1 - ok for mk, ok in zip(m, o))
    plan = []
    for j in range(nd):
        for low in (True, False):
            if (o[j] if low else b[j]) == 0:
                continue
            start_in = 0 if low else max(0, n[j] - (m[j] - 1))
            sl_in = slice(0, min(m[j], n[j])) if low else slice(start_in, n[j])
            sel, offs = [], []
            for d in range(nd):
                if d < j:
                    sel.append(slice(o[d], o[d] + n[d]))
                    offs.append(o[d])
                elif d > j:
                    sel.append(slice(None))
                    offs.append(0)
                elif low:
                    sel.append(slice(0, o[j]))
                    offs.append(0)
                else:
                    # local row r of the slab's conv is global full row start_in + r
                    lo = (o[j] + n[j]) - start_in
                    sel.append(slice(lo, lo + b[j]))
                    offs.append(o[j] + n[j])
            plan.append((j, sl_in, tuple(sel), tuple(offs)))
    return plan


def _slab_shapes(n, m, j, sl_in, sel):
    """``(conv_fft, corr_fft)``: the FFT shapes of a slab's convolution and
    of its strip's correlation."""
    slab = [len(range(*sl_in.indices(nk))) if d == j else nk for d, nk in enumerate(n)]
    full = [sk + mk - 1 for sk, mk in zip(slab, m)]
    strip = [len(range(*sl.indices(fk))) for sl, fk in zip(sel, full)]
    return (tuple(next_fast_len(f) for f in full),
            tuple(next_fast_len(sk + mk - 1) for sk, mk in zip(strip, m)))


def make_convnd_cache(dim_shape: Tuple[int, ...], filt: torch.Tensor) -> dict:
    """The kernel transfers of :func:`convnd_gram_apply`'s slab
    corrections, keyed ``("h", fft_shape)`` for the kernel and ``("c",
    fft_shape)`` for the flipped kernel, on ``filt``'s device."""
    n, m = tuple(dim_shape), tuple(filt.shape)
    axes = tuple(range(filt.ndim))
    f = filt.flip(axes)
    cache = {}
    for j, sl_in, sel, _ in _slab_plan(n, m):
        s_conv, s_corr = _slab_shapes(n, m, j, sl_in, sel)
        cache.setdefault(("h", s_conv), torch.fft.rfftn(filt, s=s_conv, dim=axes))
        cache.setdefault(("c", s_corr), torch.fft.rfftn(f, s=s_corr, dim=axes))
    return cache


def make_convnd_gram(dim_shape: Tuple[int, ...], filt: torch.Tensor):
    """``(|rfftn(filt, L)|^2, L)`` with ``L = next_fast_len(n + 2m - 2)``
    per axis, for :func:`convnd_gram_apply`."""
    L = tuple(next_fast_len(n + 2 * m - 2) for n, m in zip(dim_shape, filt.shape))
    H = torch.fft.rfftn(filt, s=L, dim=tuple(range(len(L))))
    return (H * torch.conj(H)).real, L


def convnd_gram_apply(x: torch.Tensor, filt: torch.Tensor, h2_hat: torch.Tensor, L, cache: dict = None) -> torch.Tensor:
    """Exact ``A^H A x`` of the 'same' N-D convolution (centre offset
    m // 2): one rfftn/irfftn round trip (the full convolution's Gram)
    minus the 2d disjoint boundary-slab corrections of :func:`_slab_plan`;
    ``cache`` from :func:`make_convnd_cache` skips the kernel transfers."""
    n, m = tuple(x.shape), tuple(filt.shape)
    cache = cache or {}
    axes = tuple(range(x.ndim))
    g = torch.fft.irfftn(torch.fft.rfftn(x, s=L, dim=axes) * h2_hat, s=L, dim=axes)[tuple(slice(0, k) for k in n)]
    for j, sl_in, sel, offs in _slab_plan(n, m):
        s_conv, s_corr = _slab_shapes(n, m, j, sl_in, sel)
        xs = x[tuple(sl_in if d == j else slice(None) for d in range(x.ndim))]
        cs = _conv_full_nd(xs, filt, h_hat=cache.get(("h", s_conv)))
        g = _corr_into_nd(g, cs[sel], filt, offs, c_hat=cache.get(("c", s_corr)))
    return g
