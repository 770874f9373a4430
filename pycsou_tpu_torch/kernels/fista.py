"""Fused FISTA step of the LASSO for any PSF of rank <= 4 (K8) and its plain
version.

One iteration of ``min ||A x - y||^2 + lam ||x||_1`` (APGD / FISTA)::

    x+ = prox_{tau lam |.|_1}(v - tau (2 A^H A v - 2 atb))
    v+ = x+ + a (x+ - x_prev)

with the nonnegative shrink ``max(u - tau lam, 0)`` in place of the soft
threshold when ``nonneg``.  The Gram, the prox, the momentum and the
stopping-metric partial sums run in one pass: 5 image streams (v, atb,
x_prev in; x+, v+ out).  The momentum coefficient ``a`` changes every
iteration, so it is a one-element device tensor, read by the kernel through
a pointer.
"""
from __future__ import annotations

import torch

from pycsou_tpu_torch.kernels._build import TILE, launch
from pycsou_tpu_torch.kernels.conv2d import (
    SepFactors,
    _check_device,
    _check_image,
    gram_taps,
    sepgram2d_plain,
)

__all__ = ["lasso_fista_step", "lasso_fista_step_plain"]


def lasso_fista_step_plain(v, x_prev, atb, mom, fwd: SepFactors, adj2: SepFactors, *, tau, lam,
                           nonneg=False):
    """Plain PyTorch version of K8: ``(x+, v+, stats (6,))``, the stats
    ``[|x+ - x_prev|^2, |x_prev|^2, |v+ - v|^2, |v|^2, 0, 0]``."""
    g = sepgram2d_plain(v, fwd, adj2, atb)
    u = v - tau * g
    thr = tau * lam
    if nonneg:
        x_n = torch.clamp(u - thr, min=0.0)
    else:
        x_n = torch.sign(u) * torch.clamp(u.abs() - thr, min=0.0)
    v_n = x_n + mom * (x_n - x_prev)
    dx, dv = x_n - x_prev, v_n - v
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    stats = torch.stack([torch.sum(dx * dx), torch.sum(x_prev * x_prev), torch.sum(dv * dv),
                         torch.sum(v * v), zero, zero])
    return x_n, v_n, stats


def lasso_fista_step(v, x_prev, atb, mom, fwd: SepFactors, adj2: SepFactors, *, tau, lam,
                     nonneg=False):
    """K8: one FISTA iteration, ``(x+, v+, stats (6,))`` in new buffers;
    ``mom`` a (1,) float32 tensor on the images' device and ``adj2 =
    fwd.adjoint(2.0)`` carrying the gradient's 2x.

    Replaces ``pycsou_tpu/kernels/fista.py`` ``lasso_fista_step``
    (``_fista_kernel``).  Bound by device memory: 5 image streams.  Each
    block reads v over the Gram's reach around its tile, so the outputs never
    alias the inputs (the TPU kernel's in-place update relied on an ordered
    grid)."""
    for name, t in (("v", v), ("x_prev", x_prev), ("atb", atb)):
        _check_image(t, name, like=None if name == "v" else v)
    _check_device(v, fwd, adj2)
    if mom.dtype != torch.float32 or mom.numel() != 1 or mom.device != v.device:
        raise ValueError(f"mom: need one float32 on {v.device}, got {mom.dtype} {tuple(mom.shape)} on {mom.device}")
    taps = gram_taps(fwd, adj2)
    kw = dict(tau=tau, lam=lam, nonneg=nonneg)
    if v.device.type == "cpu":
        return lasso_fista_step_plain(v, x_prev, atb, mom.reshape(()), fwd, adj2, **kw)
    H, W = v.shape
    xo, vo = torch.empty_like(v), torch.empty_like(v)
    nblocks = -(-H // TILE) * -(-W // TILE)
    partials = torch.empty(nblocks * 6, dtype=torch.float32, device=v.device)
    stats = torch.empty(6, dtype=torch.float32, device=v.device)
    mom = mom.contiguous()
    launch(
        "pct_lasso_fista", "lasso_fista_step", v,
        v.data_ptr(), x_prev.data_ptr(), atb.data_ptr(), mom.data_ptr(), xo.data_ptr(),
        vo.data_ptr(), partials.data_ptr(), stats.data_ptr(), H, W, taps.ctypes.data, fwd.rank,
        fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj2.ou, adj2.ov, float(tau), float(tau * lam),
        int(bool(nonneg)),
    )
    lasso_fista_step.launches += 1
    return xo, vo, stats


lasso_fista_step.launches = 0
