"""Expression recognition: rewrite a generic PDS configuration onto the
fused TV engines (counterpart of ``pycsou_tpu/opt/fuse.py``, TV only).

Matching is strictly structural (exact node types, default stencil
conventions), so a rewrite never changes the mathematics: the fused engine
computes the same Condat-Vu iterates to floating-point tolerance.  The F
slot takes a convolution (or plain) least-squares loss, a sampling
operator's (inpainting, zero-fill super-resolution) or a sampling operator
after a convolution (blurred super-resolution); Chambolle-Pock TV
denoising has its own matcher.  The LASSO matchers wait for ROADMAP
Queue 1 item 10.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from pycsou_tpu_torch.ops.conv import _band_factors

logger = logging.getLogger("pycsou_tpu_torch.fuse")


# -- slot predicates (None when the slot matches, else a short reason) ------


def _why_K(K, dim_shape) -> Optional[str]:
    from pycsou_tpu_torch.ops.diff import Gradient

    if type(K) is not Gradient:
        return f"K is {type(K).__name__}, not a default forward Gradient"
    if K.kind != "forward":
        return f"K uses kind={K.kind!r} (fused engine needs 'forward')"
    if not all(s == 1.0 for s in K.steps):
        return f"K has non-unit steps {tuple(K.steps)}"
    if tuple(K.dim_shape) != dim_shape:
        return "K domain does not match the solve domain"
    return None


def _why_H(H, dim_shape):
    """(lam, iso, None) on match, (None, None, reason) otherwise.
    ``lam * L21Norm(axis=0)`` is isotropic TV, ``lam * L1Norm`` anisotropic."""
    from pycsou_tpu_torch.core.functional import DiffProxFuncPostComp, ProxFuncPostComp
    from pycsou_tpu_torch.func.penalty import L1Norm, L21Norm

    lam = 1.0
    h = H
    if type(h) in (ProxFuncPostComp, DiffProxFuncPostComp):
        if h.shift != 0.0:
            return None, None, "H has a nonzero shift"
        if h.scale <= 0:
            return None, None, "H has a non-positive scale"
        lam = float(h.scale)
        h = h.func
    if type(h) is L21Norm:
        if not (h.mode == "axis" and h.axis == 0):
            return None, None, "H's L21Norm must group over axis=0 (the gradient axis)"
        iso = True
    elif type(h) is L1Norm:
        iso = False
    else:
        return None, None, (
            f"H wraps {type(h).__name__}, not L21Norm (isotropic TV) or L1Norm (anisotropic TV)"
        )
    if tuple(h.dim_shape) != (2,) + dim_shape:
        return None, None, "H domain is not the (2, H, W) gradient field"
    return lam, iso, None


def _why_G_nonneg(G):
    """(nonneg, None) on match, (None, reason) otherwise."""
    from pycsou_tpu_torch.func.base import IndicatorFunctional, NullProximableFunctional
    from pycsou_tpu_torch.math.prox import proj_nonnegative_orthant

    if type(G) is IndicatorFunctional and G.projection_fn is proj_nonnegative_orthant:
        return True, None
    if type(G) is NullProximableFunctional:
        return False, None
    return None, f"G is {type(G).__name__}, not the nonnegative orthant or absent"


def _why_F(F, dim_shape) -> Optional[str]:
    if (
        _match_conv_least_squares(dim_shape, F) is None
        and _match_sampling_least_squares(dim_shape, F) is None
        and _match_masked_conv_least_squares(dim_shape, F) is None
    ):
        return (
            f"F is {type(F).__name__}, not SquaredL2Loss (optionally composed with a "
            "Convolve2D whose PSF has rank <= 4 within 31 taps per axis, a sampling "
            "operator (Masking/DownSampling/SubSampling), or a sampling operator after "
            "such a Convolve2D)"
        )
    return None


def _match_conv_least_squares(dim_shape, F):
    """``||A x - y||^2`` with A a Convolve2D of a band-eligible PSF (returns
    ``(filt, y)``), plain ``||x - y||^2`` (returns ``(None, y)``), or None."""
    from pycsou_tpu_torch.core.functional import DiffProxFuncPreComp, ProxFuncPreComp
    from pycsou_tpu_torch.func.loss import LeastSquaresLoss
    from pycsou_tpu_torch.func.penalty import SquaredL2Norm
    from pycsou_tpu_torch.ops.conv import Convolve2D

    if type(F) is LeastSquaresLoss and type(F.op) is Convolve2D:
        if tuple(F.op.dim_shape) != dim_shape:
            return None
        filt = F.op.filt
        if _band_factors(filt.cpu().numpy()) is None:
            return None
        y = F.data
    elif type(F) in (ProxFuncPreComp, DiffProxFuncPreComp) and type(F.func) is SquaredL2Norm:
        scale = torch.as_tensor(F.scale)
        if scale.ndim != 0 or float(scale) != 1.0:
            return None
        filt, y = None, -torch.as_tensor(F.shift)
    else:
        return None
    if tuple(y.shape) != dim_shape:
        return None
    return filt, y


def _is_sampling(op) -> bool:
    """An exact sampling-operator node (its Gram is the diagonal A^H 1)."""
    from pycsou_tpu_torch.ops.sampling import DownSampling, Masking, SubSampling

    return type(op) in (Masking, DownSampling, SubSampling)


def _back_projection(M, data):
    """``(mask, y_img) = (M^H 1, M^H y)``: the sample counts and the
    zero-filled observation of a sampling operator, on the data's device."""
    ones = torch.ones(M.codim_shape, dtype=torch.float32, device=data.device)
    return M.adjoint(ones), M.adjoint(data)


def _match_sampling_least_squares(dim_shape, F):
    """``||A x - y||^2`` with A a Masking, DownSampling or SubSampling:
    ``(mask, y_img)`` for TVDeconvolution's mask mode, else None."""
    from pycsou_tpu_torch.func.loss import LeastSquaresLoss

    if type(F) is not LeastSquaresLoss or not _is_sampling(F.op):
        return None
    if tuple(F.op.dim_shape) != tuple(dim_shape):
        return None
    return _back_projection(F.op, F.data)


def _match_masked_conv_least_squares(dim_shape, F):
    """``||M C x - y||^2`` with M a sampling operator after a Convolve2D C
    of a band-eligible PSF: ``(filt, mask, y_img)`` for TVDeconvolution's
    combined mode, else None."""
    from pycsou_tpu_torch.core.linop import LinOpComp
    from pycsou_tpu_torch.func.loss import LeastSquaresLoss
    from pycsou_tpu_torch.ops.conv import Convolve2D

    if type(F) is not LeastSquaresLoss or type(F.op) is not LinOpComp:
        return None
    M, A = F.op.m1, F.op.m2
    if not _is_sampling(M) or type(A) is not Convolve2D:
        return None
    if tuple(A.dim_shape) != tuple(dim_shape):
        return None
    filt = A.filt
    if _band_factors(filt.cpu().numpy()) is None:
        return None
    return (filt,) + _back_projection(M, F.data)


def match_tv_deconvolution(dim_shape, F, G, H, K, tau: float, sigma: float, rho: float,
                           metric_every: int = 1, device=None):
    """A :class:`~pycsou_tpu_torch.opt.tv.TVDeconvolution` computing the
    same Condat-Vu iterates as ``PDS(dim_shape, F, G, H, K, tau, sigma,
    rho)``, or None when the expression does not match.

    Recognised pattern::

        min_x ||A x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})

    ``F = SquaredL2Loss(y) * A`` with ``A`` a Convolve2D, a sampling
    operator (Masking, DownSampling, SubSampling) or a sampling operator
    after a Convolve2D (or plain ``SquaredL2Loss(y)``), ``G =
    NonNegativeOrthant`` or absent, ``H = lam * L21Norm(axis=0)`` (or ``lam
    * L1Norm``), ``K = Gradient(kind='forward', step=1)``."""
    from pycsou_tpu_torch.opt.tv import TVDeconvolution

    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2 or not (tau > 0 and sigma > 0):
        return None
    if _why_K(K, dim_shape) is not None:
        return None
    lam, iso, h_reason = _why_H(H, dim_shape)
    if h_reason is not None:
        return None
    nonneg, g_reason = _why_G_nonneg(G)
    if g_reason is not None:
        return None
    # the three F flavours, in the reference's order: conv (or denoise),
    # sampling only, sampling after a conv
    filt = mask = None
    if (fy := _match_conv_least_squares(dim_shape, F)) is not None:
        filt, y = fy
    elif (my := _match_sampling_least_squares(dim_shape, F)) is not None:
        mask, y = my
    elif (mc := _match_masked_conv_least_squares(dim_shape, F)) is not None:
        filt, mask, y = mc
    else:
        return None
    return TVDeconvolution(
        dim_shape, y, lam, filt=filt, mask=mask, nonneg=nonneg, tau=float(tau),
        sigma=float(sigma), rho=float(rho), metric_every=metric_every, isotropic=iso,
        device=device,
    )


def match_cps_tv_denoise(dim_shape, F, G, H, K, tau: float, sigma: float, rho: float,
                         metric_every: int = 1, device=None):
    """Chambolle-Pock TV denoising: ``F`` absent, ``G = SquaredL2Loss(y)``
    (the data term as a prox), ``H = lam * L21Norm(axis=0)`` or ``lam *
    L1Norm``, ``K = Gradient``.  The prox step
    ``x+ = (x - tau div z + 2 tau y) / (1 + 2 tau)`` is the gradient step
    ``x - tau' (2 (x - y) + div z)`` with ``tau' = tau / (1 + 2 tau)``, so a
    denoising :class:`~pycsou_tpu_torch.opt.tv.TVDeconvolution` with
    ``tau = tau'`` (sigma unchanged, no positivity) computes CPS's
    iterates.  None on mismatch."""
    from pycsou_tpu_torch.func.base import NullDifferentiableFunctional
    from pycsou_tpu_torch.opt.tv import TVDeconvolution

    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2 or not (tau > 0 and sigma > 0):
        return None
    if type(F) is not NullDifferentiableFunctional:
        return None
    gy = _match_conv_least_squares(dim_shape, G)
    if gy is None or gy[0] is not None:  # plain ||x - y||^2 only (prox form)
        return None
    if _why_K(K, dim_shape) is not None:
        return None
    lam, iso, h_reason = _why_H(H, dim_shape)
    if h_reason is not None:
        return None
    return TVDeconvolution(
        dim_shape, gy[1], lam, filt=None, nonneg=False, tau=float(tau) / (1.0 + 2.0 * float(tau)),
        sigma=float(sigma), rho=float(rho), metric_every=metric_every, isotropic=iso,
        device=device,
    )


def explain_tv_mismatch(dim_shape, F, G, H, K) -> Optional[str]:
    """One-line "why not fused" note for a PDS configuration that almost
    matches the TV pattern (at most two slots off), else None."""
    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2:
        return None
    reasons = []
    if (r := _why_K(K, dim_shape)) is not None:
        reasons.append(r)
    _, _, r = _why_H(H, dim_shape)
    if r is not None:
        reasons.append(r)
    _, r = _why_G_nonneg(G)
    if r is not None:
        reasons.append(r)
    if (r := _why_F(F, dim_shape)) is not None:
        reasons.append(r)
    if not reasons or len(reasons) > 2:
        return None
    return "PDS expression NOT fused (runs the generic chain): " + "; ".join(reasons)
