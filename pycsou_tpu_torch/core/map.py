"""Nonlinear map calculus: shapes, arithmetic, Lipschitz propagation.

Counterpart of ``pycsou_tpu/core/map.py``.  Maps act on nd tensors
(``dim_shape`` / ``codim_shape``); arithmetic builds wrapper nodes whose
Lipschitz rules are the reference's; Jacobians default to ``torch.func``
autodiff.
"""
from __future__ import annotations

from numbers import Number
from typing import Tuple

import numpy as np
import torch

from pycsou_tpu_torch._module import Module
from pycsou_tpu_torch.utils.shapes import as_shape, size_of

__all__ = [
    "Map",
    "DifferentiableMap",
    "MapShifted",
    "MapSum",
    "MapComp",
    "DiffMapShifted",
    "DiffMapSum",
    "DiffMapComp",
]

_INF = float("inf")


def _is_arraylike(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _parts(obj):
    """The maps held in ``obj``'s attributes, directly or in lists and
    tuples."""
    stack = list(vars(obj).values())
    while stack:
        v = stack.pop()
        if isinstance(v, Map):
            yield v
        elif isinstance(v, (list, tuple)):
            stack.extend(v)


class Map(Module):
    """A map ``f: R^{dim_shape} -> R^{codim_shape}``; subclasses implement
    :meth:`apply`.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator, IdentityOperator
        >>> f1 = DiagonalOperator([1.0, 2.0])
        >>> f2 = IdentityOperator((2,))
        >>> f3 = 2.0 * f1 + f2                    # lazy expression tree
        >>> x = torch.tensor([1.0, 1.0], device=dev)
        >>> bool(torch.allclose(f3(x), 2.0 * f1(x) + f2(x)))
        True
        >>> f3.lipschitz                          # L propagates: 2*2 + 1
        5.0
    """

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF):
        self.dim_shape = as_shape(dim_shape)
        self.codim_shape = as_shape(codim_shape)
        self._lipschitz = float(lipschitz)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluate the map at ``x`` (shape ``dim_shape`` -> ``codim_shape``)."""
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(torch.as_tensor(x))

    @property
    def device(self):
        """Device of the tensors this map holds (None when it holds none)."""
        return None

    # -- shapes ------------------------------------------------------------
    @property
    def dim(self) -> int:
        return size_of(self.dim_shape)

    @property
    def codim(self) -> int:
        return size_of(self.codim_shape)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.codim, self.dim)

    # -- flags -------------------------------------------------------------
    @property
    def is_linear(self) -> bool:
        from pycsou_tpu_torch.core.linop import LinearOperator

        return isinstance(self, LinearOperator)

    @property
    def is_differentiable(self) -> bool:
        return isinstance(self, DifferentiableMap)

    @property
    def is_functional(self) -> bool:
        return self.codim_shape == ()

    # -- Lipschitz bookkeeping --------------------------------------------
    @property
    def lipschitz(self) -> float:
        """Known Lipschitz constant (``inf`` when unknown; settable)."""
        return self._lipschitz

    @lipschitz.setter
    def lipschitz(self, value: float):
        self._lipschitz = float(value)

    @property
    def lipschitz_cst(self) -> float:
        """Reference-compatible alias for :attr:`lipschitz`."""
        return self._lipschitz

    @lipschitz_cst.setter
    def lipschitz_cst(self, value: float):
        self._lipschitz = float(value)

    # -- batching ----------------------------------------------------------
    @property
    def batchable(self) -> bool:
        """Whether ``apply`` runs under ``torch.func.vmap``: true unless this
        map, or a map it is built from, launches a hand-written kernel or
        reads the host in ``apply`` (such classes set it false)."""
        return all(m.batchable for m in _parts(self))

    def _batched(self, fn, xs: torch.Tensor) -> torch.Tensor:
        """``fn`` over the leading axis of ``xs``: one ``torch.func.vmap``
        call when the map is :attr:`batchable`, else one call a row."""
        xs = torch.as_tensor(xs)
        if self.batchable:
            return torch.func.vmap(fn)(xs)
        return torch.stack([fn(x) for x in xs])

    def apply_batched(self, xs: torch.Tensor) -> torch.Tensor:
        """``apply`` over a leading batch axis."""
        return self._batched(self.apply, xs)

    apply_along_axis = apply_batched  # reference-compatible alias (batch axis first)

    # -- arithmetic --------------------------------------------------------
    def shifter(self, shift) -> "Map":
        from pycsou_tpu_torch.core import arith

        return arith.shift(self, shift)

    def argscale(self, scale) -> "Map":
        """``x -> f(scale * x)``."""
        from pycsou_tpu_torch.core import arith

        return arith.scale_input(self, scale)

    def __add__(self, other):
        from pycsou_tpu_torch.core import arith

        if isinstance(other, Map):
            return arith.add(self, other)
        return NotImplemented

    def __radd__(self, other):
        from pycsou_tpu_torch.core import arith

        if isinstance(other, Map):
            return arith.add(other, self)
        return NotImplemented

    def __mul__(self, other):
        from pycsou_tpu_torch.core import arith

        if isinstance(other, Number):
            # reference semantics: f * alpha == f(alpha * x)
            return arith.scale_input(self, other)
        if _is_arraylike(other):
            return self(other)
        if isinstance(other, Map):
            return arith.compose(self, other)
        return NotImplemented

    def __rmul__(self, other):
        from pycsou_tpu_torch.core import arith

        if isinstance(other, Number):
            # alpha * f == alpha * f(x)
            return arith.scale_output(self, other)
        if isinstance(other, Map):
            return arith.compose(other, self)
        return NotImplemented

    def __matmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        from pycsou_tpu_torch.core import arith

        return arith.scale_output(self, -1)

    def __sub__(self, other):
        if isinstance(other, Map):
            return self.__add__(other.__neg__())
        return NotImplemented

    def __pow__(self, power: int):
        """``f o f o ... o f`` (``power`` times)."""
        if not isinstance(power, int) or power < 1:
            raise NotImplementedError("power must be a positive integer")
        out = self
        for _ in range(1, power):
            out = self.__mul__(out)
        return out

    def __truediv__(self, scalar):
        if isinstance(scalar, Number):
            return self.__mul__(1 / scalar)
        return NotImplemented


class DifferentiableMap(Map):
    """Map with a Jacobian; tracks ``diff_lipschitz`` through arithmetic.
    The transposed Jacobian defaults to ``torch.func.vjp`` of ``apply``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import SquaredL2Norm
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator
        >>> F = SquaredL2Norm((2,)) * DiagonalOperator([1.0, 3.0])
        >>> F.diff_lipschitz                      # beta = 2 * L_A^2
        18.0
        >>> F.gradient(torch.tensor([1.0, 1.0], device=dev)).tolist()   # 2 A^H A x
        [2.0, 18.0]
    """

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF, diff_lipschitz: float = _INF):
        Map.__init__(self, dim_shape, codim_shape, lipschitz)
        self._diff_lipschitz = float(diff_lipschitz)

    @property
    def diff_lipschitz(self) -> float:
        """Lipschitz constant of the gradient (``beta``; settable)."""
        return self._diff_lipschitz

    @diff_lipschitz.setter
    def diff_lipschitz(self, value: float):
        self._diff_lipschitz = float(value)

    @property
    def diff_lipschitz_cst(self) -> float:
        """Reference-compatible alias for :attr:`diff_lipschitz`."""
        return self._diff_lipschitz

    @diff_lipschitz_cst.setter
    def diff_lipschitz_cst(self, value: float):
        self._diff_lipschitz = float(value)

    def compute_lipschitz_cst(self, **kwargs) -> float:
        """The known Lipschitz constant (a linear operator estimates it)."""
        return self._lipschitz

    def compute_diff_lipschitz_cst(self, **kwargs) -> float:
        """The known Lipschitz constant of the gradient."""
        return self._diff_lipschitz

    def jacobianT(self, x) -> "Map":
        from pycsou_tpu_torch.core.linop import JacobianTOperator

        return JacobianTOperator(self, torch.as_tensor(x))

    def gradient(self, x):
        return self.jacobianT(x)


# ---------------------------------------------------------------------------
# Wrapper nodes (built by pycsou_tpu_torch.core.arith)
# ---------------------------------------------------------------------------


class MapShifted(Map):
    """``x -> f(x + shift)``."""

    def __init__(self, base: Map, shift):
        shift = torch.as_tensor(shift)
        if shift.ndim > 0 and tuple(shift.shape) != base.dim_shape:
            raise ValueError(f"shift shape {tuple(shift.shape)} != dim_shape {base.dim_shape}")
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz)
        self.base = base
        self.shift = shift

    def apply(self, x):
        return self.base.apply(x + self.shift)


class MapSum(Map):
    """``f1 + f2`` with range broadcasting; L = L1 + L2."""

    def __init__(self, m1: Map, m2: Map):
        if m1.dim_shape != m2.dim_shape:
            raise ValueError(f"domain mismatch: {m1.dim_shape} vs {m2.dim_shape}")
        codim = _broadcast_codim(m1.codim_shape, m2.codim_shape)
        super().__init__(m1.dim_shape, codim, lipschitz=m1.lipschitz + m2.lipschitz)
        self.m1, self.m2 = m1, m2

    def apply(self, x):
        return self.m1.apply(x) + self.m2.apply(x)


class MapComp(Map):
    """``f1 o f2``; L = L1 * L2."""

    def __init__(self, m1: Map, m2: Map):
        if m2.codim_shape != m1.dim_shape:
            raise ValueError(
                f"cannot compose: inner codim {m2.codim_shape} != outer dim {m1.dim_shape}"
            )
        super().__init__(m2.dim_shape, m1.codim_shape, lipschitz=m1.lipschitz * m2.lipschitz)
        self.m1, self.m2 = m1, m2

    def apply(self, x):
        return self.m1.apply(self.m2.apply(x))


class DiffMapShifted(MapShifted, DifferentiableMap):
    """Shifted differentiable map; L and beta carry over."""

    def __init__(self, base: DifferentiableMap, shift):
        MapShifted.__init__(self, base, shift)
        self._diff_lipschitz = float(base.diff_lipschitz)

    def jacobianT(self, x):
        return self.base.jacobianT(torch.as_tensor(x) + self.shift)

    def gradient(self, x):
        return self.jacobianT(x)


class DiffMapSum(MapSum, DifferentiableMap):
    """Sum rule: L = L1+L2, beta = b1+b2, J^T = J1^T + J2^T."""

    def __init__(self, m1: DifferentiableMap, m2: DifferentiableMap):
        MapSum.__init__(self, m1, m2)
        self._diff_lipschitz = float(m1.diff_lipschitz + m2.diff_lipschitz)

    def jacobianT(self, x):
        x = torch.as_tensor(x)
        if self.is_functional:
            return torch.func.grad(self.apply)(x)
        if self.m1.is_functional or self.m2.is_functional:
            from pycsou_tpu_torch.core.linop import JacobianTOperator

            return JacobianTOperator(self, x)
        return self.m1.jacobianT(x) + self.m2.jacobianT(x)


class DiffMapComp(MapComp, DifferentiableMap):
    """Chain rule: L = L1*L2; beta = b1*b2*L2 in general and b1*b2 when the
    outer map is a homothety (so auto step sizes agree with the reference)."""

    def __init__(self, m1: DifferentiableMap, m2: DifferentiableMap):
        from pycsou_tpu_torch.ops.basic import HomothetyOperator

        MapComp.__init__(self, m1, m2)
        if isinstance(m1, HomothetyOperator):
            beta = m1.diff_lipschitz * m2.diff_lipschitz
        else:
            beta = m1.diff_lipschitz * m2.diff_lipschitz * m2.lipschitz
        self._diff_lipschitz = float(beta)

    def jacobianT(self, x):
        x = torch.as_tensor(x)
        if self.is_functional:
            return torch.func.grad(self.apply)(x)
        j_inner = self.m2.jacobianT(x)
        j_outer = self.m1.jacobianT(self.m2.apply(x))
        return j_inner * j_outer


def _broadcast_codim(s1: Tuple[int, ...], s2: Tuple[int, ...]) -> Tuple[int, ...]:
    if s1 == s2:
        return s1
    if s1 == ():
        return s2
    if s2 == ():
        return s1
    raise ValueError(f"codomains not broadcastable: {s1} vs {s2}")
