"""Functional calculus and the automatic proximation rules.

Counterpart of ``pycsou_tpu/core/functional.py``.  Gradients of
differentiable functionals default to ``torch.func.grad`` of ``apply``;
the prox transformation rules are kept as nodes, and a node wrapping a
differentiable functional is built as its differentiable variant
(``_PLAIN_TO_DIFF``), which keeps ``SquaredL2Loss * A`` a
DifferentiableMap.
"""
from __future__ import annotations

from numbers import Number
from typing import Optional

import torch

from pycsou_tpu_torch.core.linop import LinearOperator, UnitaryMixin
from pycsou_tpu_torch.core.map import DifferentiableMap, Map, _is_arraylike
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = [
    "Functional",
    "DifferentiableFunctional",
    "LinearFunctional",
    "ProximableFunctional",
    "ProxFuncPostComp",
    "ProxFuncAffineSum",
    "ProxFuncPreComp",
    "ProxFuncPreCompUnitOp",
]

_INF = float("inf")


def _tensor_or_float(v):
    """Scalars stay Python floats; arrays become tensors."""
    if isinstance(v, Number):
        return float(v)
    return torch.as_tensor(v)


class Functional(Map):
    """Scalar-valued map: ``codim_shape == ()``."""

    def __init__(self, dim_shape, lipschitz: float = _INF):
        Map.__init__(self, dim_shape, (), lipschitz=lipschitz)


class DifferentiableFunctional(Functional, DifferentiableMap):
    """Differentiable functional; ``gradient`` defaults to
    ``torch.func.grad(self.apply)``."""

    def __init__(self, dim_shape, lipschitz: float = _INF, diff_lipschitz: float = _INF):
        DifferentiableMap.__init__(self, dim_shape, (), lipschitz=lipschitz, diff_lipschitz=diff_lipschitz)

    def jacobianT(self, x) -> torch.Tensor:
        """Gradient tensor at ``x`` (the reference's convention for
        functionals)."""
        return torch.func.grad(self.apply)(torch.as_tensor(x))

    def gradient(self, x) -> torch.Tensor:
        return self.jacobianT(x)


class LinearFunctional(LinearOperator, Functional):
    """Linear functional ``x -> <v, x>``."""

    def __init__(self, dim_shape, lipschitz: float = _INF, dtype=torch.float32):
        LinearOperator.__init__(self, dim_shape, (), lipschitz=lipschitz, dtype=dtype)

    def asvector(self) -> torch.Tensor:
        """The Riesz representer ``v = A^H 1``."""
        from pycsou_tpu_torch.utils.device import resolve_device

        return self.adjoint(torch.ones((), dtype=self.dtype, device=resolve_device(None, self.device)))


class ProximableFunctional(Functional):
    """Convex functional with a tractable proximity operator.
    ``fenchel_prox`` follows from Moreau's identity.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L1Norm
        >>> f = L1Norm((3,))
        >>> x, tau = torch.tensor([2.0, -0.5, 1.0], device=dev), 0.5
        >>> g = 2.0 * f                            # ProxFuncPostComp node
        >>> bool(torch.allclose(g.prox(x, tau), f.prox(x, 2.0 * tau)))
        True
        >>> bool(torch.allclose(f.prox(x, 1.0) + f.fenchel_prox(x, 1.0), x))
        True
    """

    def prox(self, x: torch.Tensor, tau) -> torch.Tensor:
        """``argmin_u f(u) + ||u - x||^2 / (2 tau)``."""
        raise NotImplementedError

    def fenchel_prox(self, z: torch.Tensor, sigma) -> torch.Tensor:
        """``prox_{sigma f*}(z) = z - sigma * prox_{f/sigma}(z/sigma)``."""
        z = torch.as_tensor(z)
        return z - sigma * self.prox(z / sigma, 1.0 / sigma)

    def shifter(self, shift) -> "ProxFuncPreComp":
        return ProxFuncPreComp(self, scale=1.0, shift=shift)

    def __add__(self, other):
        if isinstance(other, LinearFunctional):
            return ProxFuncAffineSum(self, linear_part=other, intercept=0.0)
        return super().__add__(other)

    def __mul__(self, other):
        from pycsou_tpu_torch.ops.basic import HomothetyOperator

        if isinstance(other, Number):
            return ProxFuncPreComp(self, scale=other, shift=0.0)
        if _is_arraylike(other):
            # diagonal precomposition rule, valid for separable functionals
            return ProxFuncPreComp(self, scale=torch.as_tensor(other), shift=0.0)
        if isinstance(other, HomothetyOperator):
            return ProxFuncPreComp(self, scale=other.constant, shift=0.0)
        if isinstance(other, UnitaryMixin):
            return ProxFuncPreCompUnitOp(self, other)
        return super().__mul__(other)

    def __rmul__(self, other):
        if isinstance(other, Number) and other > 0:
            return ProxFuncPostComp(self, scale=float(other), shift=0.0)
        return super().__rmul__(other)


# ---------------------------------------------------------------------------
# Automatic proximation rule nodes
# ---------------------------------------------------------------------------


def _diff_variant(cls, func):
    """Build the node as its differentiable subclass when the wrapped
    functional is differentiable."""
    diff_cls = _PLAIN_TO_DIFF.get(cls)
    if diff_cls is not None and isinstance(func, DifferentiableMap):
        return object.__new__(diff_cls)
    return object.__new__(cls)


class ProxFuncPostComp(ProximableFunctional):
    """``alpha * f + c`` for ``alpha > 0``: ``prox_{tau g} = prox_{tau alpha f}``."""

    def __new__(cls, func, *args, **kwargs):
        return _diff_variant(cls, func)

    def __init__(self, func: ProximableFunctional, scale: float, shift: float = 0.0):
        super().__init__(func.dim_shape, lipschitz=abs(scale) * func.lipschitz)
        self.func = func
        self.scale = float(scale)
        self.shift = float(shift)

    @property
    def device(self):
        return self.func.device

    def apply(self, x):
        return self.scale * self.func.apply(x) + self.shift

    def prox(self, x, tau):
        return self.func.prox(x, tau * self.scale)

    def gradient(self, x):
        return self.scale * self.func.gradient(x)

    @property
    def diff_lipschitz(self):
        return abs(self.scale) * getattr(self.func, "diff_lipschitz", _INF)


class ProxFuncAffineSum(ProximableFunctional):
    """``f + <a, .> + c``: ``prox(x) = prox_f(x - tau a)``."""

    def __new__(cls, func, *args, **kwargs):
        return _diff_variant(cls, func)

    def __init__(self, func: ProximableFunctional, linear_part: LinearFunctional, intercept: float = 0.0):
        if as_shape(linear_part.dim_shape) != func.dim_shape:
            raise ValueError("affine part has mismatched domain")
        super().__init__(func.dim_shape, lipschitz=func.lipschitz + linear_part.lipschitz)
        self.func = func
        self.linear_part = linear_part
        self.intercept = float(intercept)

    @property
    def device(self):
        return self.linear_part.device or self.func.device

    def apply(self, x):
        return self.func.apply(x) + self.linear_part.apply(x) + self.intercept

    def prox(self, x, tau):
        return self.func.prox(x - tau * self.linear_part.asvector(), tau)

    def gradient(self, x):
        return self.func.gradient(x) + self.linear_part.asvector()

    @property
    def diff_lipschitz(self):
        return getattr(self.func, "diff_lipschitz", _INF)


class ProxFuncPreComp(ProximableFunctional):
    """``f(scale * x + shift)`` for scalar or elementwise ``scale``:
    ``prox(x, tau) = (prox_f(scale x + shift, tau scale^2) - shift)/scale``."""

    def __new__(cls, func, *args, **kwargs):
        return _diff_variant(cls, func)

    def __init__(self, func: ProximableFunctional, scale, shift):
        scale = _tensor_or_float(scale)
        scl: Optional[float] = float(torch.as_tensor(scale).abs().max())
        super().__init__(func.dim_shape, lipschitz=func.lipschitz * scl)
        self.func = func
        self.scale = scale
        self.shift = _tensor_or_float(shift)
        self._max_scale = scl

    @property
    def device(self):
        for v in (self.shift, self.scale):
            if isinstance(v, torch.Tensor) and v.ndim > 0:
                return v.device
        return self.func.device

    def apply(self, x):
        return self.func.apply(self.scale * x + self.shift)

    def prox(self, x, tau):
        s = self.scale
        if not isinstance(s, torch.Tensor) or s.ndim == 0:
            return (self.func.prox(s * x + self.shift, tau * s**2) - self.shift) / s
        # elementwise scale: coordinates with scale 0 keep x (the prox is the
        # identity there); separable f only
        safe = torch.where(s == 0, torch.ones_like(s), s)
        p = (self.func.prox(s * x + self.shift, tau * s**2) - self.shift) / safe
        return torch.where(s == 0, x, p)

    def gradient(self, x):
        return self.scale * self.func.gradient(self.scale * x + self.shift)

    @property
    def diff_lipschitz(self):
        return self._max_scale**2 * getattr(self.func, "diff_lipschitz", _INF)


class ProxFuncPreCompUnitOp(ProximableFunctional):
    """``f o U`` with ``U`` unitary: ``prox = U^H prox_f(U x, tau)``."""

    def __new__(cls, func, *args, **kwargs):
        return _diff_variant(cls, func)

    def __init__(self, func: ProximableFunctional, unitary: LinearOperator):
        if not isinstance(unitary, UnitaryMixin):
            raise TypeError("operator must be unitary for this prox rule")
        super().__init__(unitary.dim_shape, lipschitz=func.lipschitz)
        self.func = func
        self.unitary = unitary

    @property
    def device(self):
        return self.unitary.device or self.func.device

    def apply(self, x):
        return self.func.apply(self.unitary.apply(x))

    def prox(self, x, tau):
        return self.unitary.adjoint(self.func.prox(self.unitary.apply(x), tau))

    def gradient(self, x):
        return self.unitary.adjoint(self.func.gradient(self.unitary.apply(x)))

    @property
    def diff_lipschitz(self):
        return getattr(self.func, "diff_lipschitz", _INF)


# Differentiable variants, chosen by ``__new__`` when the wrapped functional
# is differentiable, so composed losses stay DifferentiableMaps.


class DiffProxFuncPostComp(ProxFuncPostComp, DifferentiableFunctional):
    pass


class DiffProxFuncAffineSum(ProxFuncAffineSum, DifferentiableFunctional):
    pass


class DiffProxFuncPreComp(ProxFuncPreComp, DifferentiableFunctional):
    pass


class DiffProxFuncPreCompUnitOp(ProxFuncPreCompUnitOp, DifferentiableFunctional):
    pass


_PLAIN_TO_DIFF = {
    ProxFuncPostComp: DiffProxFuncPostComp,
    ProxFuncAffineSum: DiffProxFuncAffineSum,
    ProxFuncPreComp: DiffProxFuncPreComp,
    ProxFuncPreCompUnitOp: DiffProxFuncPreCompUnitOp,
}
