"""Base functionals of the slice: indicators, nulls, the Lp-norm prox
machinery (counterpart of ``pycsou_tpu/func/base.py``)."""
from __future__ import annotations

from typing import Callable

import torch

from pycsou_tpu_torch.core.functional import DifferentiableFunctional, ProximableFunctional

__all__ = [
    "IndicatorFunctional",
    "NullDifferentiableFunctional",
    "NullProximableFunctional",
    "LpNorm",
]


class IndicatorFunctional(ProximableFunctional):
    """Indicator of a set: 0 inside, +inf outside; prox = projection."""

    def __init__(self, dim_shape, condition_fn: Callable, projection_fn: Callable):
        super().__init__(dim_shape)
        self.condition_fn = condition_fn
        self.projection_fn = projection_fn

    def apply(self, x):
        inside = torch.as_tensor(self.condition_fn(x))
        return torch.where(inside, 0.0, float("inf"))

    def prox(self, x, tau):
        del tau  # projections are scale-invariant
        return self.projection_fn(x)


class NullDifferentiableFunctional(DifferentiableFunctional):
    """Zero functional with zero gradient."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=0.0, diff_lipschitz=0.0)

    def apply(self, x):
        return torch.zeros((), dtype=torch.float32, device=torch.as_tensor(x).device)

    def jacobianT(self, x):
        return torch.zeros_like(torch.as_tensor(x))


class NullProximableFunctional(ProximableFunctional):
    """Zero functional with identity prox."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=0.0)

    def apply(self, x):
        return torch.zeros((), dtype=torch.float32, device=torch.as_tensor(x).device)

    def prox(self, x, tau):
        del tau
        return torch.as_tensor(x)


class LpNorm(ProximableFunctional):
    """Lp norms: ``prox(x, tau) = x - tau proj_{B_q}(x / tau)`` through the
    projection onto the dual-norm unit ball."""

    def dual_ball_projection(self, x):
        raise NotImplementedError

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        return x - tau * self.dual_ball_projection(x / tau)
