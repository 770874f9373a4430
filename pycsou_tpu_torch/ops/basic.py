"""Structural operators of the slice: identity, null and homothety
(counterpart of ``pycsou_tpu/ops/basic.py``; dense, sparse, diagonal and
polynomial operators wait for ROADMAP Queue 1 items 4 and 11)."""
from __future__ import annotations

from numbers import Number

import torch

from pycsou_tpu_torch.core.linop import LinearOperator, SelfAdjointMixin

__all__ = ["IdentityOperator", "NullOperator", "HomothetyOperator"]


class IdentityOperator(SelfAdjointMixin, LinearOperator):
    """Identity."""

    def __init__(self, dim_shape, dtype=torch.float32):
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)

    def apply(self, x):
        return x

    def opnorm(self, **kwargs):
        return 1.0


class NullOperator(LinearOperator):
    """Maps everything to zero."""

    def __init__(self, dim_shape, codim_shape=None, dtype=torch.float32):
        codim_shape = codim_shape if codim_shape is not None else dim_shape
        super().__init__(dim_shape, codim_shape, lipschitz=0.0, dtype=dtype)

    def apply(self, x):
        return torch.zeros(self.codim_shape, dtype=x.dtype, device=x.device)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return torch.zeros(self.dim_shape, dtype=y.dtype, device=y.device)

    def opnorm(self, **kwargs):
        return 0.0


class HomothetyOperator(SelfAdjointMixin, LinearOperator):
    """Scalar scaling ``x -> c x``; the node injected by scalar arithmetic."""

    def __init__(self, constant, dim_shape, dtype=torch.float32):
        if not isinstance(constant, Number):
            raise TypeError("HomothetyOperator constant must be a scalar")
        super().__init__(dim_shape, dim_shape, lipschitz=abs(constant), dtype=dtype)
        self.constant = constant

    def apply(self, x):
        return self.constant * x

    def opnorm(self, **kwargs):
        return abs(self.constant)
