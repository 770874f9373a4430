"""Proximal maps and projections (counterpart of ``pycsou_tpu/math/prox.py``).

Plain functions on tensors, real or complex.  None reads the host: the
l1-ball threshold is taken from one sort and one cumulative sum with a
``gather`` (not an index by a 0-d tensor), and Lambert W is a fixed
number of Halley steps, so each runs on the card without a sync.
"""
from __future__ import annotations

import torch

__all__ = [
    "sign",
    "soft",
    "proj_l1_ball",
    "proj_l2_ball",
    "proj_linfty_ball",
    "proj_nonnegative_orthant",
    "proj_segment",
    "lambertw",
]


def sign(x):
    """Complex-aware sign: ``x / |x|``, 0 at 0.

    As in the reference, the phase is ``x / |x|`` and not the conjugate
    ``conj(x) / |x|`` of the original library, whose complex soft threshold
    flips every entry's phase."""
    x = torch.as_tensor(x)
    if x.is_complex():
        mag = x.abs()
        safe = torch.where(mag == 0, torch.ones_like(mag), mag)
        return torch.where(mag == 0, torch.zeros_like(x), x / safe)
    return torch.sign(x)


def soft(x, tau):
    """Soft-thresholding ``max(|x| - tau, 0) sign(x)``."""
    x = torch.as_tensor(x)
    return torch.clamp(x.abs() - tau, min=0.0) * sign(x)


def _abs2(x) -> torch.Tensor:
    """``|x|^2`` elementwise (``x * x`` for real tensors)."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def _sqnorm(x) -> torch.Tensor:
    """``real(vdot(x, x))``: the sum of ``|x|^2``."""
    return torch.sum(_abs2(x))


def proj_l2_ball(x, radius):
    """Projection onto the l2 ball of ``radius``."""
    x = torch.as_tensor(x)
    nrm = torch.sqrt(_sqnorm(x))
    scale = torch.where(nrm <= radius, torch.ones_like(nrm), radius / torch.clamp(nrm, min=1e-30))
    return scale * x


def proj_linfty_ball(x, radius):
    """Projection onto the l-infinity ball: the modulus clipped to
    ``radius`` (an elementwise clip for real tensors)."""
    x = torch.as_tensor(x)
    if x.is_complex():
        mag = x.abs()
        return torch.where(mag <= radius, x, x * (radius / torch.clamp(mag, min=1e-30)))
    return torch.clamp(x, -radius, radius)


def proj_l1_ball(x, radius):
    """Projection onto the l1 ball: with ``u = sort(|x|, descending)``, the
    largest ``j`` with ``u_j > (cumsum(u)_j - radius) / j`` sets the soft
    threshold; ``x`` itself where it lies inside the ball."""
    x = torch.as_tensor(x)
    mag = x.abs().reshape(-1)
    u = torch.sort(mag, descending=True).values
    css = torch.cumsum(u, 0)
    j = torch.arange(1, u.numel() + 1, dtype=u.dtype, device=u.device)
    theta_cand = (css - radius) / j
    rho = torch.clamp(torch.sum(u > theta_cand) - 1, min=0)
    theta = torch.clamp(theta_cand.gather(0, rho.reshape(1)), min=0.0).reshape(())
    inside = torch.sum(mag) <= radius
    return torch.where(inside, x, soft(x, theta))


def proj_nonnegative_orthant(x):
    """Projection onto ``x >= 0`` (the real part, clipped, for complex
    tensors)."""
    x = torch.as_tensor(x)
    if x.is_complex():
        return torch.clamp(x.real, min=0.0).to(x.dtype)
    return torch.clamp(x, min=0.0)


def proj_segment(x, a=0.0, b=1.0):
    """Projection onto ``[a, b]`` per coordinate (the real part, clipped, for
    complex tensors)."""
    x = torch.as_tensor(x)
    if x.is_complex():
        return torch.clamp(x.real, a, b).to(x.dtype)
    return torch.clamp(x, a, b)


def lambertw(z, iters: int = 24):
    """Principal branch ``W0`` of the Lambert W function on ``z >= 0``:
    ``iters`` Halley steps in float32 from ``log1p(z)``."""
    z = torch.as_tensor(z, dtype=torch.float32)
    w = torch.log1p(z)
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - z
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
        w = w - f / torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
    return w
