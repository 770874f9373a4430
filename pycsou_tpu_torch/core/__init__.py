"""Core calculus: maps, linear operators, functionals, arithmetic, solver."""
from pycsou_tpu_torch.core.functional import (
    DifferentiableFunctional,
    Functional,
    ProximableFunctional,
)
from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.core.map import DifferentiableMap, Map
from pycsou_tpu_torch.core.solver import IterativeSolver, SolveInfo

__all__ = [
    "Map",
    "DifferentiableMap",
    "LinearOperator",
    "Functional",
    "DifferentiableFunctional",
    "ProximableFunctional",
    "IterativeSolver",
    "SolveInfo",
]
