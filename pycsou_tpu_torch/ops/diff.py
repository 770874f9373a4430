"""Finite-difference operators: first and second derivatives, generalised
derivatives, the stacked gradient, Laplacians, directional derivatives and
causal integration (counterpart of ``pycsou_tpu/ops/diff.py``).

Stencils are sliced tensor ops with hand-derived adjoints (divergence
forms), and spectral bounds are set in closed form, as in the reference.
The operators that hold a tensor (the edge kill's mask, a direction
field) take ``device=``; the others act on the device of their input.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.ops.basic import DiagonalOperator, HomothetyOperator, PolynomialOperator
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = [
    "fdiff_forward",
    "fdiff_forward_adjoint",
    "fdiff_backward",
    "fdiff_backward_adjoint",
    "fdiff_centered",
    "fdiff_centered_adjoint",
    "sdiff",
    "sdiff_adjoint",
    "FirstDerivative",
    "SecondDerivative",
    "GeneralisedDerivative",
    "Gradient",
    "Laplacian",
    "GeneralisedLaplacian",
    "FirstDirectionalDerivative",
    "SecondDirectionalDerivative",
    "DirectionalGradient",
    "DirectionalLaplacian",
    "Integration1D",
]

_KINDS = ("forward", "backward", "centered")


def _zeros_along(x, axis, n):
    shape = list(x.shape)
    shape[axis] = n
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def _pad(x, axis, before, after):
    parts = ([_zeros_along(x, axis, before)] if before else []) + [x]
    parts += [_zeros_along(x, axis, after)] if after else []
    return torch.cat(parts, dim=axis)


def fdiff_forward(x, axis, step=1.0):
    """``y_i = (x_{i+1} - x_i)/step``, last entry 0 (the pylops 'forward'
    edge convention)."""
    n = x.shape[axis]
    return _pad((x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)) / step, axis, 0, 1)


def fdiff_forward_adjoint(y, axis, step=1.0):
    """``(D^T y)_j = (y_{j-1} - y_j)/step`` with ``y_{-1} = y_{n-1} = 0``."""
    n = y.shape[axis]
    ypad = _pad(y.narrow(axis, 0, n - 1), axis, 1, 1)  # y_{n-1} never contributes
    return (ypad.narrow(axis, 0, n) - ypad.narrow(axis, 1, n)) / step


def fdiff_backward(x, axis, step=1.0):
    """``y_i = (x_i - x_{i-1})/step``, first entry 0."""
    n = x.shape[axis]
    return _pad((x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)) / step, axis, 1, 0)


def fdiff_backward_adjoint(y, axis, step=1.0):
    """``(D^T y)_j = (y_j - y_{j+1})/step`` with ``y_0 = y_n = 0``."""
    n = y.shape[axis]
    yc = _pad(y.narrow(axis, 1, n - 1), axis, 1, 1)  # [0, y_1 .. y_{n-1}, 0]
    return (yc.narrow(axis, 0, n) - yc.narrow(axis, 1, n)) / step


def fdiff_centered(x, axis, step=1.0):
    """``y_i = (x_{i+1} - x_{i-1})/(2 step)``, both edges 0."""
    n = x.shape[axis]
    return _pad((x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)) / (2 * step), axis, 1, 1)


def fdiff_centered_adjoint(y, axis, step=1.0):
    """``(D^T y)_j = (y_{j-1} - y_{j+1})/(2 step)``; the edge entries of
    ``y`` do not contribute."""
    n = y.shape[axis]
    yc = y.narrow(axis, 1, n - 2)
    up, dn = _pad(yc, axis, 2, 0), _pad(yc, axis, 0, 2)
    return (up.narrow(axis, 0, n) - dn.narrow(axis, 0, n)) / (2 * step)


def sdiff(x, axis, step=1.0):
    """``y_i = (x_{i-1} - 2 x_i + x_{i+1})/step^2``, edge outputs 0."""
    n = x.shape[axis]
    d = (x.narrow(axis, 0, n - 2) - 2 * x.narrow(axis, 1, n - 2) + x.narrow(axis, 2, n - 2)) / step**2
    return _pad(d, axis, 1, 1)


def sdiff_adjoint(y, axis, step=1.0):
    """Adjoint of :func:`sdiff`: the same stencil on the edge-zeroed ``y``,
    without zeroing the output's edges."""
    n = y.shape[axis]
    ypad = _pad(_pad(y.narrow(axis, 1, n - 2), axis, 1, 1), axis, 1, 1)
    return (ypad.narrow(axis, 0, n) - 2 * ypad.narrow(axis, 1, n) + ypad.narrow(axis, 2, n)) / step**2


_FORWARD = {"forward": fdiff_forward, "backward": fdiff_backward, "centered": fdiff_centered}
_ADJOINT = {"forward": fdiff_forward_adjoint, "backward": fdiff_backward_adjoint,
            "centered": fdiff_centered_adjoint}


def _check_kind(kind):
    if kind not in _KINDS:
        raise ValueError("kind must be forward/backward/centered")


def _steps(step, d):
    return tuple([float(step)] * d) if np.isscalar(step) else tuple(float(s) for s in step)


class FirstDerivative(LinearOperator):
    """First derivative along ``axis``: 'forward', 'backward' or 'centered'
    differences; ``L = 2/step`` (1/step centered).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.diff import FirstDerivative
        >>> D = FirstDerivative((4,))
        >>> D(torch.tensor([0.0, 1.0, 3.0, 3.0], device=dev)).tolist()   # forward differences
        [1.0, 2.0, 0.0, 0.0]
        >>> x, y = torch.arange(4.0, device=dev), torch.ones(4, device=dev)
        >>> bool(torch.isclose(torch.dot(D(x), y), torch.dot(x, D.adjoint(y))))
        True
    """

    def __init__(self, dim_shape, axis: int = 0, kind: str = "forward", step: float = 1.0,
                 dtype=torch.float32):
        _check_kind(kind)
        dim_shape = as_shape(dim_shape)
        lip = (1.0 if kind == "centered" else 2.0) / step
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.axis = int(axis)
        self.kind = kind
        self.step = float(step)

    def apply(self, x):
        return _FORWARD[self.kind](x, self.axis, self.step)

    def adjoint(self, y):
        return _ADJOINT[self.kind](torch.as_tensor(y), self.axis, self.step)


class SecondDerivative(LinearOperator):
    """Second derivative along ``axis`` with zeroed edge rows;
    ``L = 4/step^2``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.diff import SecondDerivative
        >>> D2 = SecondDerivative((4,))
        >>> D2(torch.tensor([0.0, 1.0, 4.0, 9.0], device=dev)).tolist()  # x^2 -> 2, edges 0
        [0.0, 2.0, 2.0, 0.0]
    """

    def __init__(self, dim_shape, axis: int = 0, step: float = 1.0, dtype=torch.float32):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=4.0 / step**2, dtype=dtype)
        self.axis = int(axis)
        self.step = float(step)

    def apply(self, x):
        return sdiff(x, self.axis, self.step)

    def adjoint(self, y):
        return sdiff_adjoint(torch.as_tensor(y), self.axis, self.step)


def _edge_kill(dim_shape, axis, width, device):
    """Diagonal mask zeroing ``width`` boundary samples along ``axis``."""
    n = dim_shape[axis]
    mask1d = np.ones(n, dtype=np.float32)
    mask1d[:width] = 0
    mask1d[n - width :] = 0
    shape = [1] * len(dim_shape)
    shape[axis] = n
    return DiagonalOperator(np.broadcast_to(mask1d.reshape(shape), dim_shape).copy(), device=device)


def GeneralisedDerivative(dim_shape, axis: int = 0, kind: str = "iterated", order: int = 1,
                          alpha: float = 1.0, coeffs=None, step: float = 1.0, kill_edges: bool = True,
                          dtype=torch.float32, device=None) -> LinearOperator:
    """Generalised 1-D differential operator from the operator algebra, on
    the centered derivative ``D``:

    * ``'iterated'``: ``D^N``
    * ``'sobolev'``: ``(alpha^2 I - D2)^N``
    * ``'exponential'``: ``(alpha I + D)^N``
    * ``'polynomial'``: ``sum_k c_k D^k``

    with ``kill_edges`` zeroing ``N`` (the degree) samples at each end
    along ``axis`` (a ``DiagonalOperator`` on ``device``)."""
    dim_shape = as_shape(dim_shape)
    D = FirstDerivative(dim_shape, axis=axis, kind="centered", step=step, dtype=dtype)
    if kind == "iterated":
        op, width = D**order, order
    elif kind == "sobolev":
        D2 = SecondDerivative(dim_shape, axis=axis, step=step, dtype=dtype)
        op, width = (HomothetyOperator(alpha**2, dim_shape, dtype=dtype) - D2) ** order, order
    elif kind == "exponential":
        op, width = (HomothetyOperator(alpha, dim_shape, dtype=dtype) + D) ** order, order
    elif kind == "polynomial":
        if coeffs is None:
            raise ValueError("polynomial kind requires coeffs")
        op, width = PolynomialOperator(D, coeffs), len(np.asarray(coeffs)) - 1
    else:
        raise ValueError(f"unknown kind {kind!r}")
    if kill_edges and width > 0:
        op = _edge_kill(dim_shape, axis, width, resolve_device(device)) * op
    return op


class Gradient(LinearOperator):
    """Stacked first differences along every axis, a ``(d, *dim_shape)``
    output; the adjoint is the negative divergence.  Lipschitz
    ``sqrt(sum (2/s)^2)`` (``sqrt(8)`` for a unit-step 2-D image;
    ``1/s`` an axis for the 'centered' kind) in closed form.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.diff import Gradient
        >>> G = Gradient((2, 2))
        >>> x = torch.tensor([[0.0, 1.0], [2.0, 3.0]], device=dev)
        >>> tuple(G(x).shape)                  # (axes, H, W)
        (2, 2, 2)
        >>> G(x)[1].tolist()                   # d/dx1
        [[1.0, 0.0], [1.0, 0.0]]
    """

    def __init__(self, dim_shape, kind: str = "forward", step: Union[float, Sequence[float]] = 1.0,
                 dtype=torch.float32):
        _check_kind(kind)
        dim_shape = as_shape(dim_shape)
        steps = _steps(step, len(dim_shape))
        per_axis = [(1.0 if kind == "centered" else 2.0) / s for s in steps]
        lip = math.sqrt(sum(p**2 for p in per_axis))
        super().__init__(dim_shape, (len(dim_shape),) + dim_shape, lipschitz=lip, dtype=dtype)
        self.kind = kind
        self.steps = steps

    def apply(self, x):
        f = _FORWARD[self.kind]
        return torch.stack([f(x, a, s) for a, s in enumerate(self.steps)], dim=0)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        f = _ADJOINT[self.kind]
        return sum(f(y[a], a, s) for a, s in enumerate(self.steps))


class Laplacian(LinearOperator):
    """Sum of second derivatives along ``axes`` (the 5-point stencil in
    2-D); ``L = sum 4/s^2``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.diff import Laplacian
        >>> L = Laplacian((3, 3))
        >>> x = torch.zeros(3, 3, device=dev)
        >>> x[1, 1] = 1.0
        >>> float(L(x)[1, 1])                  # -4 at the peak
        -4.0
    """

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None,
                 step: Union[float, Sequence[float]] = 1.0, dtype=torch.float32):
        dim_shape = as_shape(dim_shape)
        axes = tuple(range(len(dim_shape))) if axes is None else tuple(axes)
        steps = _steps(step, len(axes))
        super().__init__(dim_shape, dim_shape, lipschitz=sum(4.0 / s**2 for s in steps), dtype=dtype)
        self.axes = axes
        self.steps = steps

    def apply(self, x):
        return sum(sdiff(x, a, s) for a, s in zip(self.axes, self.steps))

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return sum(sdiff_adjoint(y, a, s) for a, s in zip(self.axes, self.steps))


def GeneralisedLaplacian(dim_shape, kind: str = "iterated", order: int = 1, alpha: float = 1.0, coeffs=None,
                         step: float = 1.0, kill_edges: bool = True, dtype=torch.float32,
                         device=None) -> LinearOperator:
    """Iterated (``L^N``), Sobolev (``(alpha^2 I - L)^N``) or polynomial
    operators in the Laplacian, with the edge kill along every axis."""
    dim_shape = as_shape(dim_shape)
    L = Laplacian(dim_shape, step=step, dtype=dtype)
    if kind == "iterated":
        op, width = L**order, order
    elif kind == "sobolev":
        op, width = (HomothetyOperator(alpha**2, dim_shape, dtype=dtype) - L) ** order, order
    elif kind == "polynomial":
        if coeffs is None:
            raise ValueError("polynomial kind requires coeffs")
        op, width = PolynomialOperator(L, coeffs), len(np.asarray(coeffs)) - 1
    else:
        raise ValueError(f"unknown kind {kind!r}")
    if kill_edges and width > 0:
        dev = resolve_device(device)
        for a in range(len(dim_shape)):
            op = _edge_kill(dim_shape, a, width, dev) * op
    return op


def _canon_directions(directions, dim_shape) -> np.ndarray:
    v = np.asarray(directions.cpu() if isinstance(directions, torch.Tensor) else directions, dtype=np.float32)
    d = len(dim_shape)
    if v.ndim == 1:
        if v.shape[0] != d:
            raise ValueError("constant direction must have one entry per axis")
        v = v.reshape((d,) + (1,) * d) * np.ones((d,) + dim_shape, dtype=np.float32)
    elif v.shape != (d,) + dim_shape:
        raise ValueError(f"directions must be shaped {(d,) + dim_shape}")
    return v


class FirstDirectionalDerivative(LinearOperator):
    """Derivative along a (possibly spatially varying) vector field:
    ``d_v x = sum_a v_a * D_a x`` with centered ``D_a``;
    ``L = max |v| * 2 sqrt(d) / step``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.diff import FirstDirectionalDerivative
        >>> D = FirstDirectionalDerivative((4, 4), directions=(1.0, 0.0))
        >>> x = torch.arange(16.0, device=dev).reshape(4, 4)
        >>> D(x)[1:3, 0].tolist()              # interior rows
        [4.0, 4.0]
    """

    def __init__(self, dim_shape, directions, step: float = 1.0, dtype=torch.float32, device=None):
        dim_shape = as_shape(dim_shape)
        dev = resolve_device(device, directions)
        v = _canon_directions(directions, dim_shape)
        vmax = float(np.max(np.sqrt(np.sum(v**2, axis=0))))
        super().__init__(dim_shape, dim_shape, lipschitz=vmax * 2.0 * math.sqrt(len(dim_shape)) / step,
                         dtype=dtype)
        self.directions = as_tensor(v, dev, dtype)
        self.step = float(step)

    @property
    def device(self):
        return self.directions.device

    def apply(self, x):
        return sum(self.directions[a] * fdiff_centered(x, a, self.step) for a in range(len(self.dim_shape)))

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return sum(fdiff_centered_adjoint(self.directions[a] * y, a, self.step) for a in range(len(self.dim_shape)))


def SecondDirectionalDerivative(dim_shape, directions, step: float = 1.0, kill_edges: bool = True,
                                dtype=torch.float32, device=None):
    """``-d_v^H d_v``, with two samples killed at each edge of every axis."""
    d1 = FirstDirectionalDerivative(dim_shape, directions, step=step, dtype=dtype, device=device)
    op = -(d1.H * d1)
    if kill_edges:
        for a in range(len(as_shape(dim_shape))):
            op = _edge_kill(as_shape(dim_shape), a, 2, d1.device) * op
    return op


class DirectionalGradient(LinearOperator):
    """Stack of directional derivatives along several fields."""

    def __init__(self, dim_shape, directions_list, step: float = 1.0, dtype=torch.float32, device=None):
        dim_shape = as_shape(dim_shape)
        ops = tuple(FirstDirectionalDerivative(dim_shape, v, step=step, dtype=dtype, device=device)
                    for v in directions_list)
        lip = math.sqrt(sum(o.lipschitz**2 for o in ops))
        super().__init__(dim_shape, (len(ops),) + dim_shape, lipschitz=lip, dtype=dtype)
        self.ops = ops

    @property
    def device(self):
        return self.ops[0].device

    def apply(self, x):
        return torch.stack([o.apply(x) for o in self.ops], dim=0)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return sum(o.adjoint(y[i]) for i, o in enumerate(self.ops))


def DirectionalLaplacian(dim_shape, directions_list, weights=None, step: float = 1.0, dtype=torch.float32,
                         device=None):
    """Weighted sum of second directional derivatives."""
    if weights is None:
        weights = [1.0] * len(directions_list)
    op = None
    for w, v in zip(weights, directions_list):
        term = float(w) * SecondDirectionalDerivative(dim_shape, v, step=step, dtype=dtype, device=device)
        op = term if op is None else op + term
    return op


class Integration1D(LinearOperator):
    """Causal cumulative integration along ``axis``; the adjoint integrates
    anti-causally.  ``L`` is the cumsum matrix's exact largest singular
    value.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.diff import Integration1D
        >>> S = Integration1D((4,))
        >>> S(torch.ones(4, device=dev)).tolist()
        [1.0, 2.0, 3.0, 4.0]
        >>> S.adjoint(torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)).tolist()
        [1.0, 1.0, 1.0, 1.0]
    """

    def __init__(self, dim_shape, axis: int = 0, step: float = 1.0, dtype=torch.float32):
        dim_shape = as_shape(dim_shape)
        n = dim_shape[axis]
        lip = step / (2 * math.sin(math.pi / (4 * n + 2)))
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.axis = int(axis)
        self.step = float(step)

    def apply(self, x):
        return torch.cumsum(x, dim=self.axis) * self.step

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return torch.flip(torch.cumsum(torch.flip(y, (self.axis,)), dim=self.axis), (self.axis,)) * self.step
