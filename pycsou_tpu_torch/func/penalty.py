"""Penalty functionals of the slice (counterpart of
``pycsou_tpu/func/penalty.py``): SquaredL2Norm, L1Norm, L21Norm in axis mode
and the nonnegative orthant.  The other penalties, and L21Norm's ``groups``
mode, wait for ROADMAP Queue 1 item 7."""
from __future__ import annotations

import math

import torch

from pycsou_tpu_torch.core.functional import DifferentiableFunctional, ProximableFunctional
from pycsou_tpu_torch.func.base import IndicatorFunctional, LpNorm
from pycsou_tpu_torch.math.prox import proj_linfty_ball, proj_nonnegative_orthant, soft
from pycsou_tpu_torch.utils.shapes import as_shape, size_of

__all__ = ["SquaredL2Norm", "L1Norm", "L21Norm", "NonNegativeOrthant"]

_INF = float("inf")


class SquaredL2Norm(DifferentiableFunctional, ProximableFunctional):
    """``||x||_2^2``: gradient ``2x`` (beta = 2), prox ``x / (1 + 2 tau)``."""

    def __init__(self, dim_shape):
        DifferentiableFunctional.__init__(self, dim_shape, lipschitz=_INF, diff_lipschitz=2.0)

    def apply(self, x):
        return torch.sum(x * x)

    def jacobianT(self, x):
        return 2 * torch.as_tensor(x)

    def prox(self, x, tau):
        return torch.as_tensor(x) / (1.0 + 2.0 * tau)


class L1Norm(LpNorm):
    """``||x||_1``: prox = soft threshold."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=math.sqrt(size_of(as_shape(dim_shape))))

    def apply(self, x):
        return torch.sum(torch.abs(x))

    def dual_ball_projection(self, x):
        return proj_linfty_ball(x, 1.0)

    def prox(self, x, tau):
        return soft(x, tau)


class L21Norm(ProximableFunctional):
    """Group norm ``sum_g ||x_g||_2`` over the fibres along ``axis`` (axis
    mode: isotropic TV over a ``(2, H, W)`` gradient field), with the
    group-wise shrinkage prox."""

    def __init__(self, dim_shape, groups=None, axis: int = 0):
        if groups is not None:
            raise NotImplementedError(
                "L21Norm groups= mode is not ported yet (ROADMAP Queue 1 item 7); use axis="
            )
        super().__init__(dim_shape)
        self.axis = int(axis)
        self.mode = "axis"

    def _group_norms(self, x):
        return torch.sqrt(torch.sum(x * x, dim=self.axis, keepdim=True))

    def apply(self, x):
        return torch.sum(self._group_norms(torch.as_tensor(x)))

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        norms = self._group_norms(x)
        scale = torch.clamp(1.0 - tau / torch.clamp(norms, min=1e-30), min=0.0)
        return scale * x


def NonNegativeOrthant(dim_shape) -> IndicatorFunctional:
    """Indicator of ``x >= 0``."""
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.all(x >= 0),
        projection_fn=proj_nonnegative_orthant,
    )
