"""Loss functionals of the slice (counterpart of ``pycsou_tpu/func/loss.py``):
the data-shifted squared l2 loss and the least-squares node its composition
with a linear operator builds.  The other losses wait for ROADMAP Queue 1
item 7."""
from __future__ import annotations

import torch

from pycsou_tpu_torch.core.functional import DifferentiableFunctional
from pycsou_tpu_torch.func.penalty import SquaredL2Norm
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = ["DifferentiableLoss", "SquaredL2Loss", "LeastSquaresLoss"]


def DifferentiableLoss(func: DifferentiableFunctional, data, device=None):
    """``phi(x - y)`` keeping gradient and Lipschitz constants."""
    dev = resolve_device(device, data)
    return func.shifter(shift=-as_tensor(data, dev))


def SquaredL2Loss(dim_shape, data, device=None):
    """``||y - x||_2^2`` (beta = 2).  Composed with a linear operator it
    builds :class:`LeastSquaresLoss`."""
    return DifferentiableLoss(SquaredL2Norm(dim_shape), data=data, device=device)


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
        r = self.op.apply(x) - self.data
        return torch.sum(r * r)

    def jacobianT(self, x):
        x = torch.as_tensor(x)
        gf = getattr(self._gram, "grad_fused", None)
        if gf is not None:
            return gf(x, self._atb)
        return 2.0 * (self._gram.apply(x) - self._atb)

    @property
    def diff_lipschitz(self):
        return 2.0 * self.op.lipschitz**2
