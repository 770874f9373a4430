"""Core calculus: maps, linear operators, functionals, arithmetic, solver."""
from pycsou_tpu_torch.core.functional import (
    DifferentiableFunctional,
    Functional,
    LinearFunctional,
    ProximableFunctional,
)
from pycsou_tpu_torch.core.linop import LinearOperator, UnitaryMixin
from pycsou_tpu_torch.core.map import DifferentiableMap, Map
from pycsou_tpu_torch.core.solver import IterativeSolver, SolveInfo

__all__ = [
    "Map",
    "DifferentiableMap",
    "LinearOperator",
    "UnitaryMixin",
    "Functional",
    "LinearFunctional",
    "DifferentiableFunctional",
    "ProximableFunctional",
    "IterativeSolver",
    "SolveInfo",
]
