"""Fused PMYULA Langevin sample for any PSF of rank <= 4 (K9), its plain
version, and the counter-based Gaussian generator both use.

One sample of the deconvolution posterior ``exp(-||A x - y||^2 - G(x))``::

    x+  = (1 - gamma/tau) x - gamma 2 (A^H A x - atb)
          + (gamma/tau) prox_{tau G}(x) + sqrt(2 gamma) xi
    m1+ = m1 + w x+,   m2+ = m2 + w x+^2

with ``prox`` none (``G`` absent: ``x+ = x - gamma g + sqrt(2 gamma) xi``),
the nonnegative projection, or the soft threshold at ``tau lam``.  The
Gram, the prox blend, the noise and the collect-gated accumulators run in
one pass: 7 image streams.

The noise: :func:`normal_noise` is Philox4x32-10 keyed by ``(seed, n)``
with the flat pixel index as the counter, then Box-Muller on two 24-bit
uniforms (``u1`` in (0, 1]).  The kernel draws the same numbers in
``noise_mode="prng"`` (up to a few ulp of ``logf``/``cosf``), so the fused
and the generic samplers see the same ``xi``.  Nothing touches PyTorch's
global generator.
"""
from __future__ import annotations

import numpy as np
import torch

from pycsou_tpu_torch.kernels._build import check, library, stream_of
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    _check_device,
    _check_image,
    gram_taps,
    sepgram2d_plain,
)

__all__ = ["PROX_MODES", "normal_noise", "pmyula_mega_step", "pmyula_mega_step_plain"]

PROX_MODES = ("none", "nonneg", "l1")
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments


def _mulhilo(a: int, b: torch.Tensor):
    """``(hi, lo)`` words of the 64-bit product of the constant ``a`` and
    the 32-bit words ``b`` (int64 tensor), from 16-bit halves: an int64
    product of two 32-bit words would overflow."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def _philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) on the counters ``(c0, c1, c2,
    c3)`` (int64 tensors of 32-bit words) under the key ``(k0, k1)`` (0-d
    int64 tensors): the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normal_noise(seed, n, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` (float32 on ``device``) for sample ``n``
    of the chain ``seed``: deterministic per ``(seed, n)``, independent
    across pixels.  ``seed`` and ``n`` are ints or 0-d integer tensors (a
    device tensor keeps the host from waiting on the card); both are taken
    modulo 2**32.  The counter is the flat pixel index."""
    shape = tuple(shape)
    k0 = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    k1 = torch.as_tensor(n, dtype=torch.int64, device=device) & _MASK
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    b1, b2, _, _ = _philox4x32_10(idx & _MASK, idx >> 32, zero, zero, k0, k1)
    scale = 1.0 / (1 << 24)
    u1 = 1.0 - (b1 >> 8).to(torch.float32) * scale
    u2 = (b2 >> 8).to(torch.float32) * scale
    r = torch.sqrt(-2.0 * torch.log(u1))
    return (r * torch.cos(6.283185307179586 * u2)).reshape(shape)


def _coefficients(gamma, tau, lam):
    """``(c1, cp, ns, thr)`` as float32 values: ``1 - gamma/tau``,
    ``gamma/tau``, ``sqrt(2 gamma)`` (the square root taken in float32, as
    the reference does) and ``tau lam``."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return (f32(1.0 - gamma / tau), f32(gamma / tau), float(np.sqrt(np.float32(2.0 * gamma))),
            f32(tau * lam))


def _prox(x, mode, thr):
    if mode == "nonneg":
        return torch.clamp(x, min=0.0)
    return torch.sign(x) * torch.clamp(x.abs() - thr, min=0.0)


def pmyula_mega_step_plain(x, atb, m1, m2, si, wf, fwd: SepFactors, adj2: SepFactors, *, gamma,
                           tau, lam=0.0, prox_mode="none", noise_mode="prng", noise=None):
    """Plain PyTorch version of K9: ``(x+, m1+, m2+)``; in ``"prng"`` mode
    the noise is :func:`normal_noise` ``(si[0], si[1])``."""
    c1, cp, ns, thr = _coefficients(gamma, tau, lam)
    gw = sepgram2d_plain(x, fwd, adj2, atb)
    xi = noise if noise_mode == "stream" else normal_noise(si[0], si[1], x.shape, x.device)
    if prox_mode == "none":
        x_n = x - gamma * gw
    else:
        x_n = c1 * x - gamma * gw + cp * _prox(x, prox_mode, thr)
    x_n = x_n + ns * xi
    wx = wf.reshape(()) * x_n
    return x_n, m1 + wx, m2 + wx * x_n


def pmyula_mega_step(x, atb, m1, m2, si, wf, fwd: SepFactors, adj2: SepFactors, *, gamma, tau,
                     lam=0.0, prox_mode="none", noise_mode="prng", noise=None):
    """K9: one fused PMYULA sample, ``(x+, m1+, m2+)`` in new buffers.

    ``si``: (2,) int32 ``[seed, n]``; ``wf``: (1,) float32 collect weight;
    both on the images' device.  ``adj2 = fwd.adjoint(2.0)`` carries the
    gradient's 2x.  ``noise_mode="prng"`` draws xi in the kernel,
    ``"stream"`` reads the image ``noise``.

    Replaces ``pycsou_tpu/kernels/langevin.py`` ``pmyula_mega_step``
    (``_pmyula_kernel``).  Bound by device memory: 7 image streams (8 with a
    streamed xi).  Each block reads x over the Gram's reach around its tile,
    so the outputs never alias the inputs."""
    if prox_mode not in PROX_MODES:
        raise ValueError(f"unknown prox_mode {prox_mode!r}; expected one of {PROX_MODES}")
    if noise_mode not in ("prng", "stream"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    images = [("x", x), ("atb", atb), ("m1", m1), ("m2", m2)]
    if noise_mode == "stream":
        if noise is None:
            raise ValueError("noise_mode='stream' needs the noise image")
        images.append(("noise", noise))
    for name, t in images:
        _check_image(t, name, like=None if name == "x" else x)
    _check_device(x, fwd, adj2)
    for name, t, dt, n in (("si", si, torch.int32, 2), ("wf", wf, torch.float32, 1)):
        if t.dtype != dt or t.numel() != n or t.device != x.device:
            raise ValueError(f"{name}: need {n} {dt} on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    taps = gram_taps(fwd, adj2)
    kw = dict(gamma=gamma, tau=tau, lam=lam, prox_mode=prox_mode, noise_mode=noise_mode, noise=noise)
    if x.device.type == "cpu":
        return pmyula_mega_step_plain(x, atb, m1, m2, si, wf, fwd, adj2, **kw)
    c1, cp, ns, thr = _coefficients(gamma, tau, lam)
    H, W = x.shape
    xo, m1o, m2o = (torch.empty_like(x) for _ in range(3))
    si, wf = si.contiguous(), wf.contiguous()
    err = library().pct_pmyula(
        x.data_ptr(), atb.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        noise.data_ptr() if noise_mode == "stream" else 0, si.data_ptr(), wf.data_ptr(),
        xo.data_ptr(), m1o.data_ptr(), m2o.data_ptr(), H, W, taps.ctypes.data, fwd.rank, fwd.Ku,
        fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov, float(gamma), c1, cp, ns, thr,
        PROX_MODES.index(prox_mode), stream_of(x),
    )
    check(err, "pmyula_mega_step")
    pmyula_mega_step.launches += 1
    return xo, m1o, m2o


pmyula_mega_step.launches = 0
