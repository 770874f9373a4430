"""Arithmetic dispatch: picks the most specific wrapper node so linearity,
differentiability and proximability survive composition
(counterpart of ``pycsou_tpu/core/arith.py``).

``SquaredL2Loss(y) * A`` composes to :class:`LeastSquaresLoss`, whose
gradient goes through ``A.gram``; ``lam * L21Norm`` to a
:class:`ProxFuncPostComp`; ``f + <a, .>`` to a :class:`ProxFuncAffineSum`;
``L1Norm * U`` with a unitary ``U`` to a :class:`ProxFuncPreCompUnitOp`,
whose prox is ``U^H prox(U x)``.
"""
from __future__ import annotations

from numbers import Number

import torch

from pycsou_tpu_torch.core.functional import (
    LinearFunctional,
    ProxFuncAffineSum,
    ProxFuncPostComp,
    ProxFuncPreComp,
    ProxFuncPreCompUnitOp,
    ProximableFunctional,
)
from pycsou_tpu_torch.core.linop import LinearOperator, LinOpComp, LinOpSum, UnitaryMixin
from pycsou_tpu_torch.core.map import (
    DifferentiableMap,
    DiffMapComp,
    DiffMapShifted,
    DiffMapSum,
    Map,
    MapComp,
    MapShifted,
    MapSum,
)

__all__ = ["add", "compose", "scale_input", "scale_output", "shift"]


def add(m1: Map, m2: Map) -> Map:
    if isinstance(m1, ProximableFunctional) and isinstance(m2, LinearFunctional):
        return ProxFuncAffineSum(m1, linear_part=m2, intercept=0.0)
    if isinstance(m2, ProximableFunctional) and isinstance(m1, LinearFunctional):
        return ProxFuncAffineSum(m2, linear_part=m1, intercept=0.0)
    if isinstance(m1, LinearOperator) and isinstance(m2, LinearOperator):
        return LinOpSum(m1, m2)
    if isinstance(m1, DifferentiableMap) and isinstance(m2, DifferentiableMap):
        return DiffMapSum(m1, m2)
    return MapSum(m1, m2)


def compose(m1: Map, m2: Map) -> Map:
    from pycsou_tpu_torch.ops.basic import HomothetyOperator

    if isinstance(m1, ProximableFunctional):
        if isinstance(m2, HomothetyOperator):
            return ProxFuncPreComp(m1, scale=m2.constant, shift=0.0)
        if isinstance(m2, UnitaryMixin):
            return ProxFuncPreCompUnitOp(m1, m2)
    if isinstance(m2, LinearOperator):
        data = _squared_l2_data(m1, m2)
        if data is not None:
            # ||. - y||^2 o A -> least-squares node whose gradient goes
            # through A's Gram: 2 (A^H A x - A^H y)
            from pycsou_tpu_torch.func.loss import LeastSquaresLoss

            return LeastSquaresLoss(m2, data=data)
    if isinstance(m1, LinearOperator) and isinstance(m2, LinearOperator):
        return LinOpComp(m1, m2)
    if isinstance(m1, DifferentiableMap) and isinstance(m2, DifferentiableMap):
        return DiffMapComp(m1, m2)
    return MapComp(m1, m2)


def _squared_l2_data(m: Map, op: LinearOperator):
    """y if ``m`` is ``||. - y||^2`` (a SquaredL2Norm, possibly data-shifted
    with unit scale), else None."""
    from pycsou_tpu_torch.func.penalty import SquaredL2Norm

    if isinstance(m, SquaredL2Norm):
        return torch.zeros(m.dim_shape, dtype=torch.float32, device=op.device)
    if isinstance(m, ProxFuncPreComp) and isinstance(m.func, SquaredL2Norm):
        scale = torch.as_tensor(m.scale)
        if scale.ndim == 0 and float(scale) == 1.0:
            return -torch.as_tensor(m.shift)
    return None


def scale_input(m: Map, alpha) -> Map:
    """``x -> f(alpha x)``."""
    from pycsou_tpu_torch.ops.basic import HomothetyOperator

    if isinstance(alpha, Number) and alpha == 1:
        return m
    if isinstance(m, ProximableFunctional):
        return ProxFuncPreComp(m, scale=alpha, shift=0.0)
    return compose(m, HomothetyOperator(alpha, m.dim_shape))


def scale_output(m: Map, alpha) -> Map:
    """``x -> alpha f(x)``."""
    from pycsou_tpu_torch.ops.basic import HomothetyOperator

    if isinstance(alpha, Number) and alpha == 1:
        return m
    if isinstance(m, ProximableFunctional) and isinstance(alpha, Number) and alpha > 0:
        return ProxFuncPostComp(m, scale=float(alpha), shift=0.0)
    return compose(HomothetyOperator(alpha, m.codim_shape), m)


def shift(m: Map, s) -> Map:
    """``x -> f(x + s)``."""
    if isinstance(m, ProximableFunctional):
        return ProxFuncPreComp(m, scale=1.0, shift=s)
    if isinstance(m, DifferentiableMap):
        return DiffMapShifted(m, s)
    return MapShifted(m, s)
