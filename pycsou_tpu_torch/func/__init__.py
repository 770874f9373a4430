"""Functionals of the TV-deconvolution slice."""
from pycsou_tpu_torch.func.base import (
    IndicatorFunctional,
    LpNorm,
    NullDifferentiableFunctional,
    NullProximableFunctional,
)
from pycsou_tpu_torch.func.loss import DifferentiableLoss, LeastSquaresLoss, SquaredL2Loss
from pycsou_tpu_torch.func.penalty import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Norm

__all__ = [
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
