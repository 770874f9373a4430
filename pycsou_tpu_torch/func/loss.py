"""Loss functionals (counterpart of ``pycsou_tpu/func/loss.py``): norms and
balls precomposed with the data shift ``phi(x - y)``, the equality
indicator, the Kullback-Leibler divergence, and the least-squares node
that ``SquaredL2Loss(y) * A`` builds.

Each takes ``device=`` (else the data's device, else the port's default)
and keeps the data's dtype: complex data stay complex (``complex64``)."""
from __future__ import annotations

import torch

from pycsou_tpu_torch.core.functional import DifferentiableFunctional, ProxFuncPreComp, ProximableFunctional
from pycsou_tpu_torch.func.base import IndicatorFunctional
from pycsou_tpu_torch.func.penalty import (
    L1Ball,
    L1Norm,
    L2Ball,
    L2Norm,
    LInftyBall,
    LInftyNorm,
    SquaredL1Norm,
    SquaredL2Norm,
)
from pycsou_tpu_torch.math.prox import _sqnorm
from pycsou_tpu_torch.utils.device import as_tensor, dtype_of, resolve_device

__all__ = [
    "ProximableLoss",
    "DifferentiableLoss",
    "L2Loss",
    "SquaredL2Loss",
    "L2BallLoss",
    "L1Loss",
    "SquaredL1Loss",
    "L1BallLoss",
    "LInftyLoss",
    "LInftyBallLoss",
    "ConsistencyLoss",
    "KLDivergence",
    "LeastSquaresLoss",
]


def _data(data, device) -> torch.Tensor:
    """The data as a tensor of its own dtype (``float32`` or ``complex64``)
    on ``device``, else its device, else the port's default."""
    return as_tensor(data, resolve_device(device, data), dtype_of(data))


def ProximableLoss(func: ProximableFunctional, data, device=None) -> ProximableFunctional:
    """``phi(x - y)`` keeping the prox: ``prox(x) = y + prox_phi(x - y)``."""
    return ProxFuncPreComp(func, scale=1.0, shift=-_data(data, device))


def DifferentiableLoss(func: DifferentiableFunctional, data, device=None):
    """``phi(x - y)`` keeping gradient and Lipschitz constants."""
    return func.shifter(shift=-_data(data, device))


def L2Loss(dim_shape, data, device=None) -> ProximableFunctional:
    """``||y - x||_2``."""
    return ProximableLoss(L2Norm(dim_shape), data=data, device=device)


def SquaredL2Loss(dim_shape, data, device=None):
    """``||y - x||_2^2`` (beta = 2).  Composed with a linear operator it
    builds :class:`LeastSquaresLoss`."""
    return DifferentiableLoss(SquaredL2Norm(dim_shape), data=data, device=device)


def L2BallLoss(dim_shape, data, radius: float = 1.0, device=None) -> ProximableFunctional:
    """Indicator of ``||y - x||_2 <= radius``."""
    return ProximableLoss(L2Ball(dim_shape, radius=radius), data=data, device=device)


def L1Loss(dim_shape, data, device=None) -> ProximableFunctional:
    """``||y - x||_1``, the robust data fidelity."""
    return ProximableLoss(L1Norm(dim_shape), data=data, device=device)


def SquaredL1Loss(dim_shape, data, prox_computation: str = "sort", device=None) -> ProximableFunctional:
    """``||y - x||_1^2``."""
    return ProximableLoss(SquaredL1Norm(dim_shape, prox_computation=prox_computation), data=data, device=device)


def L1BallLoss(dim_shape, data, radius: float = 1.0, device=None) -> ProximableFunctional:
    """Indicator of ``||y - x||_1 <= radius``."""
    return ProximableLoss(L1Ball(dim_shape, radius=radius), data=data, device=device)


def LInftyLoss(dim_shape, data, device=None) -> ProximableFunctional:
    """``||y - x||_inf``."""
    return ProximableLoss(LInftyNorm(dim_shape), data=data, device=device)


def LInftyBallLoss(dim_shape, data, radius: float = 1.0, device=None) -> ProximableFunctional:
    """Indicator of ``||y - x||_inf <= radius``."""
    return ProximableLoss(LInftyBall(dim_shape, radius=radius), data=data, device=device)


class _Consistency(IndicatorFunctional):
    """The equality indicator, holding its data (for :attr:`device`)."""

    def __init__(self, dim_shape, data: torch.Tensor):
        super().__init__(dim_shape, condition_fn=self._equal, projection_fn=self._project)
        self.data = data

    @property
    def device(self):
        return self.data.device

    def _equal(self, x):
        return torch.all(torch.as_tensor(x) == self.data)

    def _project(self, x):
        x = torch.as_tensor(x)
        return torch.broadcast_to(self.data, x.shape).to(x.dtype)


def ConsistencyLoss(dim_shape, data, device=None) -> IndicatorFunctional:
    """Equality indicator of ``x == y``, with prox ``y``."""
    return _Consistency(dim_shape, _data(data, device))


class LeastSquaresLoss(DifferentiableFunctional):
    """``F(x) = ||A x - y||^2`` with the gradient through the operator's
    Gram, ``2 (A^H A x - A^H y)``, and ``A^H y`` precomputed.  When the
    Gram has ``grad_fused`` (a separable convolution), the whole gradient is
    one kernel pass (K2)."""

    def __init__(self, op, data):
        data = torch.as_tensor(data)
        DifferentiableFunctional.__init__(
            self, op.dim_shape, lipschitz=float("inf"), diff_lipschitz=2.0 * op.lipschitz**2
        )
        self.op = op
        self.data = data
        self._gram = op.gram
        self._atb = op.adjoint(data)

    @property
    def device(self):
        return self.data.device

    def apply(self, x):
        return _sqnorm(self.op.apply(x) - self.data)

    def jacobianT(self, x):
        x = torch.as_tensor(x)
        gf = getattr(self._gram, "grad_fused", None)
        if gf is not None:
            return gf(x, self._atb)
        return 2.0 * (self._gram.apply(x) - self._atb)

    @property
    def diff_lipschitz(self):
        return 2.0 * self.op.lipschitz**2


class KLDivergence(ProximableFunctional):
    """Generalised Kullback-Leibler divergence ``D(y || x) = sum y log(y/x) +
    x - y`` on ``x >= 0`` (``y log(y/x) = 0`` where ``y == 0``; +inf where
    any ``x < 0``, decided on the device), the Poisson data fidelity, with
    the closed-form prox ``(x - tau + sqrt((x - tau)^2 + 4 tau y)) / 2``."""

    def __init__(self, dim_shape, data, device=None):
        super().__init__(dim_shape)
        self.data = _data(data, device)

    @property
    def device(self):
        return self.data.device

    def apply(self, x):
        x = torch.as_tensor(x)
        y = self.data
        xpos, ypos = x > 0, y > 0
        ratio = torch.where(ypos & xpos, y / torch.where(xpos, x, torch.ones_like(x)), torch.ones_like(y))
        terms = torch.where(ypos, y * torch.log(ratio), torch.zeros_like(y)) + x - y
        val = torch.sum(terms)
        return torch.where(torch.any(x < 0), torch.full_like(val, float("inf")), val)

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        return 0.5 * (x - tau + torch.sqrt((x - tau) ** 2 + 4 * tau * self.data))
