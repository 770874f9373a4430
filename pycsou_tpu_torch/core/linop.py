"""Matrix-free linear operator algebra.

Counterpart of ``pycsou_tpu/core/linop.py``.  ``adjoint`` defaults to the
vector-Jacobian product of ``apply`` (``torch.func.vjp``, in place of
``jax.linear_transpose``); closed forms override it where a kernel is
cheaper.  Spectral estimation (``opnorm``) waits for ROADMAP Queue 1 item 3
(``utils/opnorm.py``) and raises.
"""
from __future__ import annotations

import torch

from pycsou_tpu_torch.core.map import DifferentiableMap, Map

__all__ = [
    "LinearOperator",
    "SelfAdjointMixin",
    "AdjointOperator",
    "LinOpSum",
    "LinOpComp",
    "SymmetricLinearOperator",
    "JacobianTOperator",
]

_INF = float("inf")


class LinearOperator(DifferentiableMap):
    """Abstract real linear operator: implement ``apply``; ``adjoint`` is
    derived.  ``diff_lipschitz`` equals ``lipschitz`` (the reference's
    convention for linear maps)."""

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF, dtype=torch.float32):
        DifferentiableMap.__init__(self, dim_shape, codim_shape, lipschitz=lipschitz, diff_lipschitz=lipschitz)
        self.dtype = dtype

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """``A^H y`` as the vector-Jacobian product of ``apply`` (exact for
        a linear map, at any linearisation point)."""
        y = torch.as_tensor(y)
        primal = torch.zeros(self.dim_shape, dtype=self.dtype, device=y.device)
        _, vjp = torch.func.vjp(self.apply, primal)
        (out,) = vjp(y)
        return out

    @property
    def lipschitz(self) -> float:
        """Spectral-norm bound; setting it also sets ``diff_lipschitz``."""
        return self._lipschitz

    @lipschitz.setter
    def lipschitz(self, value: float):
        self._lipschitz = float(value)
        self._diff_lipschitz = float(value)

    def jacobianT(self, x=None):
        return self.H

    @property
    def H(self) -> "LinearOperator":
        return AdjointOperator(self)

    @property
    def gram(self) -> "LinearOperator":
        """``A^H A``."""
        return SymmetricLinearOperator(LinOpComp(self.H, self))

    def opnorm(self, **kwargs) -> float:
        raise NotImplementedError(
            f"{type(self).__name__}.opnorm: power iteration is not ported yet "
            "(ROADMAP Queue 1 item 3, utils/opnorm.py); set .lipschitz explicitly"
        )

    def compute_lipschitz_cst(self, **kwargs) -> float:
        value = self.opnorm(**kwargs)
        self.lipschitz = value
        return value


class SelfAdjointMixin:
    """Mixin for operators with ``A^H = A``."""

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))


class AdjointOperator(LinearOperator):
    """``A^H`` as an operator."""

    def __init__(self, base: LinearOperator):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        return self.base.adjoint(x)

    def adjoint(self, y):
        return self.base.apply(y)

    @property
    def H(self):
        return self.base


class LinOpSum(LinearOperator):
    """``A + B``; the adjoint is the sum of adjoints."""

    def __init__(self, m1: LinearOperator, m2: LinearOperator):
        if m1.dim_shape != m2.dim_shape:
            raise ValueError(f"domain mismatch: {m1.dim_shape} vs {m2.dim_shape}")
        codim = m1.codim_shape if m1.codim_shape != () else m2.codim_shape
        if m1.codim_shape not in ((), codim) or m2.codim_shape not in ((), codim):
            raise ValueError(f"codomain mismatch: {m1.codim_shape} vs {m2.codim_shape}")
        super().__init__(m1.dim_shape, codim, lipschitz=m1.lipschitz + m2.lipschitz, dtype=m1.dtype)
        self.m1, self.m2 = m1, m2

    @property
    def device(self):
        return self.m1.device or self.m2.device

    def apply(self, x):
        return self.m1.apply(x) + self.m2.apply(x)

    def adjoint(self, y):
        # a scalar-valued summand inside an array-valued sum acts through the
        # broadcast operator, whose adjoint sums y
        def term(m):
            if m.codim_shape == () and self.codim_shape != ():
                return m.adjoint(torch.sum(y))
            return m.adjoint(y)

        y = torch.as_tensor(y)
        return term(self.m1) + term(self.m2)


class LinOpComp(LinearOperator):
    """``A o B``; the adjoint is the reversed composition."""

    def __init__(self, m1: LinearOperator, m2: LinearOperator):
        if m2.codim_shape != m1.dim_shape:
            raise ValueError(
                f"cannot compose: inner codim {m2.codim_shape} != outer dim {m1.dim_shape}"
            )
        super().__init__(m2.dim_shape, m1.codim_shape, lipschitz=m1.lipschitz * m2.lipschitz, dtype=m1.dtype)
        self.m1, self.m2 = m1, m2

    @property
    def device(self):
        return self.m1.device or self.m2.device

    def apply(self, x):
        return self.m1.apply(self.m2.apply(x))

    def adjoint(self, y):
        return self.m2.adjoint(self.m1.adjoint(y))


class SymmetricLinearOperator(LinearOperator):
    """Declares an operator self-adjoint."""

    def __init__(self, base: LinearOperator):
        if base.dim_shape != base.codim_shape:
            raise ValueError("symmetric operator must be square")
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        return self.base.apply(x)

    def adjoint(self, y):
        return self.base.apply(torch.as_tensor(y))


class JacobianTOperator(LinearOperator):
    """Transposed Jacobian of a differentiable map at a point, from autodiff:
    ``apply`` is the VJP, ``adjoint`` the JVP."""

    def __init__(self, base: Map, point: torch.Tensor):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=point.dtype)
        self.base = base
        self.point = point

    def apply(self, v):
        _, vjp = torch.func.vjp(self.base.apply, self.point)
        (out,) = vjp(v)
        return out

    def adjoint(self, u):
        _, out = torch.func.jvp(self.base.apply, (self.point,), (u,))
        return out
