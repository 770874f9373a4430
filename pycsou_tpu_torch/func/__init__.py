"""Functionals: base, losses and penalties."""
from pycsou_tpu_torch.func.base import (
    DiffFuncHStack,
    ExplicitLinearFunctional,
    IndicatorFunctional,
    LpNorm,
    NullDifferentiableFunctional,
    NullProximableFunctional,
    ProxFuncHStack,
)
from pycsou_tpu_torch.func.loss import DifferentiableLoss, LeastSquaresLoss, SquaredL2Loss
from pycsou_tpu_torch.func.penalty import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Norm

__all__ = [
    "DiffFuncHStack",
    "ExplicitLinearFunctional",
    "ProxFuncHStack",
    "IndicatorFunctional",
    "LpNorm",
    "NullDifferentiableFunctional",
    "NullProximableFunctional",
    "DifferentiableLoss",
    "LeastSquaresLoss",
    "SquaredL2Loss",
    "L1Norm",
    "L21Norm",
    "NonNegativeOrthant",
    "SquaredL2Norm",
]
