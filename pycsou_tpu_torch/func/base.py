"""Base functionals: explicit linear functionals, indicators, nulls, the
Lp-norm prox machinery and separable stacks (counterpart of
``pycsou_tpu/func/base.py``)."""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from pycsou_tpu_torch.core.functional import DifferentiableFunctional, LinearFunctional, ProximableFunctional
from pycsou_tpu_torch.utils.device import as_tensor, dtype_of, resolve_device
from pycsou_tpu_torch.utils.shapes import split_flat

__all__ = [
    "ExplicitLinearFunctional",
    "IndicatorFunctional",
    "NullDifferentiableFunctional",
    "NullProximableFunctional",
    "LpNorm",
    "ProxFuncHStack",
    "DiffFuncHStack",
]

_INF = float("inf")


class ExplicitLinearFunctional(LinearFunctional):
    """``x -> <v, x>``; ``lipschitz = ||v||``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.base import ExplicitLinearFunctional
        >>> f = ExplicitLinearFunctional([1.0, 2.0])
        >>> float(f(torch.tensor([3.0, 4.0], device=dev)))
        11.0
        >>> f.adjoint(2.0).tolist()
        [2.0, 4.0]
    """

    def __init__(self, vec, dtype=None, device=None):
        dev = resolve_device(device, vec)
        vec = as_tensor(vec, dev, dtype_of(vec) if dtype is None else dtype)
        lip = float(np.linalg.norm(vec.cpu().numpy().ravel()))  # the reference's numpy bound
        super().__init__(tuple(vec.shape), lipschitz=lip, dtype=vec.dtype)
        self.vec = vec

    @property
    def device(self):
        return self.vec.device

    def apply(self, x):
        return torch.vdot(self.vec.reshape(-1), torch.as_tensor(x).reshape(-1))

    def adjoint(self, alpha):
        return self.vec * torch.as_tensor(alpha)

    def asvector(self):
        return self.vec


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
    projection onto the dual-norm unit ball.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L1Norm
        >>> f = L1Norm((3,))
        >>> x, tau = torch.tensor([1.0, -2.0, 0.5], device=dev), 0.7
        >>> lhs = f.prox(x, tau) + tau * f.fenchel_prox(x / tau, 1.0 / tau)   # Moreau
        >>> bool(torch.allclose(lhs, x, atol=1e-6))
        True
    """

    def dual_ball_projection(self, x):
        raise NotImplementedError

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        return x - tau * self.dual_ball_projection(x / tau)


class ProxFuncHStack(ProximableFunctional):
    """Separable sum ``F(x1, ..., xk) = sum_i f_i(x_i)`` over a partition of
    a flat vector: the prox splits, proxes each block, concatenates.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.base import ProxFuncHStack
        >>> from pycsou_tpu_torch.func.penalty import L1Norm, NonNegativeOrthant
        >>> f = ProxFuncHStack([L1Norm((2,)), NonNegativeOrthant((2,))])
        >>> f.prox(torch.tensor([2.0, -0.5, -1.0, 3.0], device=dev), tau=1.0).tolist()
        [1.0, -0.0, 0.0, 3.0]
    """

    def __init__(self, funcs: Sequence[ProximableFunctional]):
        funcs = tuple(funcs)
        super().__init__((sum(f.dim for f in funcs),))
        self.funcs = funcs

    @property
    def device(self):
        return next((f.device for f in self.funcs if f.device is not None), None)

    def apply(self, x):
        blocks = split_flat(torch.as_tensor(x), [f.dim_shape for f in self.funcs])
        return sum(f.apply(b) for f, b in zip(self.funcs, blocks))

    def prox(self, x, tau):
        blocks = split_flat(torch.as_tensor(x), [f.dim_shape for f in self.funcs])
        return torch.cat([f.prox(b, tau).reshape(-1) for f, b in zip(self.funcs, blocks)])


class DiffFuncHStack(DifferentiableFunctional):
    """Separable sum of differentiable functionals; the gradient
    concatenates the blocks' gradients.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.base import DiffFuncHStack
        >>> from pycsou_tpu_torch.func.penalty import SquaredL2Norm
        >>> f = DiffFuncHStack([SquaredL2Norm((2,)), SquaredL2Norm((1,))])
        >>> f.gradient(torch.tensor([1.0, 2.0, 3.0], device=dev)).tolist()
        [2.0, 4.0, 6.0]
    """

    def __init__(self, funcs: Sequence[DifferentiableFunctional]):
        funcs = tuple(funcs)
        super().__init__((sum(f.dim for f in funcs),), lipschitz=sum(f.lipschitz for f in funcs),
                         diff_lipschitz=max(f.diff_lipschitz for f in funcs))
        self.funcs = funcs

    @property
    def device(self):
        return next((f.device for f in self.funcs if f.device is not None), None)

    def apply(self, x):
        blocks = split_flat(torch.as_tensor(x), [f.dim_shape for f in self.funcs])
        return sum(f.apply(b) for f, b in zip(self.funcs, blocks))

    def jacobianT(self, x):
        blocks = split_flat(torch.as_tensor(x), [f.dim_shape for f in self.funcs])
        return torch.cat([f.gradient(b).reshape(-1) for f, b in zip(self.funcs, blocks)])
