"""Finite-difference operators of the slice (counterpart of
``pycsou_tpu/ops/diff.py``): forward differences and the stacked
``Gradient``.  The other stencils wait for ROADMAP Queue 1 item 3."""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["fdiff_forward", "fdiff_forward_adjoint", "Gradient"]


def _zeros_along(x, axis, n):
    shape = list(x.shape)
    shape[axis] = n
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def fdiff_forward(x, axis, step=1.0):
    """``y_i = (x_{i+1} - x_i)/step``, last entry 0 (the pylops 'forward'
    edge convention)."""
    n = x.shape[axis]
    d = (x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)) / step
    return torch.cat([d, _zeros_along(x, axis, 1)], dim=axis)


def fdiff_forward_adjoint(y, axis, step=1.0):
    """``(D^T y)_j = (y_{j-1} - y_j)/step`` with ``y_{-1} = y_{n-1} = 0``."""
    n = y.shape[axis]
    y = y.narrow(axis, 0, n - 1)  # y_{n-1} never contributes
    z = _zeros_along(y, axis, 1)
    ypad = torch.cat([z, y, z], dim=axis)
    return (ypad.narrow(axis, 0, n) - ypad.narrow(axis, 1, n)) / step


class Gradient(LinearOperator):
    """Stacked forward differences along every axis: ``(d, *dim_shape)``
    output, adjoint the negative divergence.  ``||K|| <= sqrt(sum 4/s^2)``
    (``sqrt(8)`` for a unit-step 2-D image) in closed form.  Only the
    'forward' kind is ported; 'backward'/'centered' wait for ROADMAP Queue 1
    item 3."""

    def __init__(self, dim_shape, kind: str = "forward", step: Union[float, Sequence[float]] = 1.0,
                 dtype=torch.float32):
        if kind != "forward":
            raise NotImplementedError(
                f"Gradient kind={kind!r} is not ported yet (ROADMAP Queue 1 item 3)"
            )
        dim_shape = as_shape(dim_shape)
        d = len(dim_shape)
        steps = tuple([float(step)] * d) if np.isscalar(step) else tuple(float(s) for s in step)
        per_axis = [2.0 / s for s in steps]
        lip = math.sqrt(sum(p**2 for p in per_axis))
        super().__init__(dim_shape, (d,) + dim_shape, lipschitz=lip, dtype=dtype)
        self.kind = kind
        self.steps = steps

    def apply(self, x):
        return torch.stack([fdiff_forward(x, a, s) for a, s in enumerate(self.steps)], dim=0)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return sum(fdiff_forward_adjoint(y[a], a, s) for a, s in enumerate(self.steps))
