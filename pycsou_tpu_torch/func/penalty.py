"""Penalty functionals: norms, balls, barriers, entropy, quadratic forms
(counterpart of ``pycsou_tpu/func/penalty.py``).

Each ``apply``, ``prox`` and ``gradient`` is a plain function of device
tensors, real or complex (``|x|^2`` where the reference takes
``real(vdot(x, x))``), and none reads the host: the l1-ball projection and
``SquaredL1Norm``'s ``'sort'`` prox take their threshold by ``gather``, its
``'root'`` prox bisects 60 times and the entropy prox runs 30 Newton steps,
each a fixed loop of device operations.  ``L21Norm``'s groups mode sums
its groups with ``index_add`` (on the card, in no fixed order)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.functional import DifferentiableFunctional, ProximableFunctional
from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.func.base import IndicatorFunctional, LpNorm
from pycsou_tpu_torch.math.prox import (
    _abs2,
    _sqnorm,
    proj_l1_ball,
    proj_l2_ball,
    proj_linfty_ball,
    proj_nonnegative_orthant,
    proj_segment,
    soft,
)
from pycsou_tpu_torch.utils.device import resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape, size_of

__all__ = [
    "L2Norm",
    "SquaredL2Norm",
    "L2Ball",
    "L1Norm",
    "SquaredL1Norm",
    "L1Ball",
    "LInftyNorm",
    "LInftyBall",
    "L21Norm",
    "NonNegativeOrthant",
    "Segment",
    "RealLine",
    "ImagLine",
    "LogBarrier",
    "ShannonEntropy",
    "QuadraticForm",
]

_INF = float("inf")


class L2Norm(LpNorm):
    """``||x||_2``: prox is the block soft threshold ``max(1 - tau/||x||, 0) x``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L2Norm
        >>> f = L2Norm((2,))
        >>> float(f(torch.tensor([3.0, 4.0], device=dev)))
        5.0
        >>> f.prox(torch.tensor([3.0, 4.0], device=dev), tau=2.5).tolist()
        [1.5, 2.0]
    """

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=1.0)

    def apply(self, x):
        return torch.sqrt(_sqnorm(torch.as_tensor(x)))

    def dual_ball_projection(self, x):
        return proj_l2_ball(x, 1.0)

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        nrm = torch.sqrt(_sqnorm(x))
        return torch.clamp(1.0 - tau / torch.clamp(nrm, min=1e-30), min=0.0) * x


class SquaredL2Norm(DifferentiableFunctional, ProximableFunctional):
    """``||x||_2^2``: gradient ``2x`` (beta = 2), prox ``x / (1 + 2 tau)``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import SquaredL2Norm
        >>> f = SquaredL2Norm((2,))
        >>> x = torch.tensor([1.0, 2.0], device=dev)
        >>> float(f(x)), f.gradient(x).tolist()
        (5.0, [2.0, 4.0])
        >>> f.prox(torch.tensor([2.0, 4.0], device=dev), tau=0.5).tolist()
        [1.0, 2.0]
    """

    def __init__(self, dim_shape):
        DifferentiableFunctional.__init__(self, dim_shape, lipschitz=_INF, diff_lipschitz=2.0)

    def apply(self, x):
        return _sqnorm(torch.as_tensor(x))

    def jacobianT(self, x):
        return 2 * torch.as_tensor(x)

    def prox(self, x, tau):
        return torch.as_tensor(x) / (1.0 + 2.0 * tau)


def L2Ball(dim_shape, radius: float) -> IndicatorFunctional:
    """Indicator of ``||x||_2 <= radius``; prox = projection.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L2Ball
        >>> f = L2Ball((2,), radius=1.0)
        >>> f.prox(torch.tensor([3.0, 4.0], device=dev), tau=1.0).tolist()  # projection
        [0.6000000238418579, 0.800000011920929]
    """
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.sqrt(_sqnorm(torch.as_tensor(x))) <= radius,
        projection_fn=lambda x: proj_l2_ball(x, radius),
    )


class L1Norm(LpNorm):
    """``||x||_1``: prox = soft threshold.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L1Norm
        >>> f = L1Norm((3,))
        >>> float(f(torch.tensor([1.0, -2.0, 0.5], device=dev)))
        3.5
        >>> f.prox(torch.tensor([1.0, -2.0, 0.5], device=dev), tau=1.0).tolist()
        [0.0, -1.0, 0.0]
    """

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=math.sqrt(size_of(as_shape(dim_shape))))

    def apply(self, x):
        return torch.sum(torch.abs(x))

    def dual_ball_projection(self, x):
        return proj_linfty_ball(x, 1.0)

    def prox(self, x, tau):
        return soft(x, tau)

    def soft(self, x, tau):
        """Elementwise soft-thresholding (the l1 prox; the reference's alias)."""
        return soft(x, tau)


class SquaredL1Norm(ProximableFunctional):
    """``||x||_1^2`` with two prox algorithms: ``'sort'`` (one sort and one
    cumulative sum, the threshold gathered on the device) and ``'root'``
    (60 bisection steps on the multiplier from ``(1e-12, mu_max)`` in
    float32, as the reference).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import SquaredL1Norm
        >>> x = torch.tensor([1.0, -2.0, 0.5], device=dev)
        >>> float(SquaredL1Norm((3,))(x))
        12.25
        >>> p_sort = SquaredL1Norm((3,), 'sort').prox(x, tau=0.5)
        >>> p_root = SquaredL1Norm((3,), 'root').prox(x, tau=0.5)
        >>> bool(torch.allclose(p_sort, p_root, atol=1e-5))
        True
    """

    def __init__(self, dim_shape, prox_computation: str = "sort"):
        super().__init__(dim_shape)
        if prox_computation not in ("sort", "root"):
            raise ValueError("prox_computation must be 'sort' or 'root'")
        self.prox_computation = prox_computation

    def apply(self, x):
        return torch.sum(torch.abs(x)) ** 2

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        if self.prox_computation == "sort":
            return self._prox_sort(x, tau)
        return self._prox_root(x, tau)

    def _prox_sort(self, x, tau):
        y = torch.sort(x.abs().reshape(-1), descending=True).values
        css = torch.cumsum(y, 0)
        k = torch.arange(1, y.numel() + 1, dtype=y.dtype, device=y.device)
        test = y - (2 * tau / (1 + k * 2 * tau)) * css
        pos = torch.arange(y.numel(), device=y.device)
        idx = torch.max(torch.where(test > 0, pos, torch.full_like(pos, -1)))
        safe = torch.clamp(idx, min=0)
        thr = (2 * tau / (1 + (safe + 1) * 2 * tau)) * css.gather(0, safe.reshape(1)).reshape(())
        thr = torch.where(idx < 0, torch.zeros_like(thr), thr)
        return soft(x, thr)

    def _prox_root(self, x, tau):
        mag = x.abs()
        norm = torch.sqrt(torch.sum(mag**2))
        mu_max = torch.clamp(torch.max(mag**2) / (4 * tau), min=2e-12)

        def f(mu):
            return torch.sum(torch.clamp(mag * torch.sqrt(tau / mu) - 2 * tau, min=0.0)) - 1.0

        a, b = torch.full_like(mu_max, 1e-12), mu_max
        for _ in range(60):
            m = 0.5 * (a + b)
            fa_pos = f(m) > 0
            a, b = torch.where(fa_pos, m, a), torch.where(fa_pos, b, m)
        mu_star = 0.5 * (a + b)
        lam = torch.clamp(mag * torch.sqrt(tau / mu_star) - 2 * tau, min=0.0)
        out = lam * x / (lam + 2 * tau)
        return torch.where(norm > 0, out, x)


def L1Ball(dim_shape, radius: float) -> IndicatorFunctional:
    """Indicator of ``||x||_1 <= radius``; prox = the sort-based projection.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L1Ball
        >>> f = L1Ball((2,), radius=1.0)
        >>> f.prox(torch.tensor([2.0, 0.0], device=dev), tau=1.0).tolist()
        [1.0, 0.0]
    """
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.sum(torch.abs(x)) <= radius,
        projection_fn=lambda x: proj_l1_ball(x, radius),
    )


class LInftyNorm(LpNorm):
    """``||x||_inf``: prox by Moreau's rule through the l1-ball projection.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import LInftyNorm
        >>> f = LInftyNorm((2,))
        >>> float(f(torch.tensor([1.0, -3.0], device=dev)))
        3.0
        >>> f.prox(torch.tensor([1.0, -3.0], device=dev), tau=1.0).tolist()
        [1.0, -2.0]
    """

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=1.0)

    def apply(self, x):
        return torch.max(torch.abs(x))

    def dual_ball_projection(self, x):
        return proj_l1_ball(x, 1.0)


def LInftyBall(dim_shape, radius: float) -> IndicatorFunctional:
    """Indicator of ``||x||_inf <= radius``; prox = the modulus clip.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import LInftyBall
        >>> LInftyBall((2,), radius=2.0).prox(torch.tensor([3.0, -1.0], device=dev), 1.0).tolist()
        [2.0, -1.0]
    """
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.max(torch.abs(x)) <= radius,
        projection_fn=lambda x: proj_linfty_ball(x, radius),
    )


def _relabel(groups):
    """``(inverse, n_groups)``: each entry's rank among the distinct labels,
    as ``np.unique(groups, return_inverse=True)`` gives it, flat."""
    g = groups.cpu().numpy() if isinstance(groups, torch.Tensor) else np.asarray(groups)
    _, inv = np.unique(g.reshape(-1), return_inverse=True)
    inv = inv.reshape(-1)
    return inv, int(inv.max()) + 1 if inv.size else 0


class L21Norm(ProximableFunctional):
    """Group norm ``sum_g ||x_g||_2`` with the group-wise shrinkage prox.

    * axis mode: the groups are the fibres along ``axis`` (isotropic TV
      over a ``(2, H, W)`` gradient field);
    * groups mode: a label per entry of the flat input, relabelled ``0 ..
      n_groups - 1`` once, at construction (``np.unique``'s inverse); the group
      norms are an ``index_add`` over the flat input, the prox gathers each
      entry's scale.  The labels live on ``device`` (else the labels'
      device, else the port's default).

    As in the reference, labels that are all distinct build an
    :class:`L1Norm`, and a single group an :class:`L2Norm`.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import L21Norm
        >>> f = L21Norm((2, 2), axis=0)       # groups = the 2-vectors per column
        >>> float(f(torch.tensor([[3.0, 0.0], [4.0, 1.0]], device=dev)))
        6.0
        >>> g = L21Norm((4,), groups=[0, 0, 1, 1])
        >>> float(g(torch.tensor([3.0, 4.0, 0.0, 1.0], device=dev)))
        6.0
    """

    def __new__(cls, dim_shape, groups=None, axis: int = 0, device=None):
        if groups is not None:
            inv, n_groups = _relabel(groups)
            if n_groups == inv.size:
                return L1Norm(dim_shape)
            if n_groups == 1:
                return L2Norm(dim_shape)
            obj = super().__new__(cls)
            obj._relabelled = (inv, n_groups)
            return obj
        return super().__new__(cls)

    def __init__(self, dim_shape, groups=None, axis: int = 0, device=None):
        super().__init__(dim_shape)
        self.axis = int(axis)
        if groups is None:
            self.groups, self.n_groups, self.mode = None, 0, "axis"
            return
        inv, self.n_groups = self.__dict__.pop("_relabelled", None) or _relabel(groups)
        self.groups = torch.as_tensor(inv, dtype=torch.long, device=resolve_device(device, groups))
        self.mode = "groups"

    @property
    def device(self):
        return None if self.groups is None else self.groups.device

    def _group_norms(self, x):
        if self.mode == "axis":
            return torch.sqrt(torch.sum(_abs2(x), dim=self.axis, keepdim=True))
        sq = _abs2(x.reshape(-1))
        sums = torch.zeros(self.n_groups, dtype=sq.dtype, device=sq.device)
        return torch.sqrt(sums.index_add_(0, self.groups, sq))

    def apply(self, x):
        return torch.sum(self._group_norms(torch.as_tensor(x)))

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        norms = self._group_norms(x)
        scale = torch.clamp(1.0 - tau / torch.clamp(norms, min=1e-30), min=0.0)
        if self.mode == "axis":
            return scale * x
        return (scale.index_select(0, self.groups) * x.reshape(-1)).reshape(x.shape)


def NonNegativeOrthant(dim_shape) -> IndicatorFunctional:
    """Indicator of ``x >= 0``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import NonNegativeOrthant
        >>> NonNegativeOrthant((2,)).prox(torch.tensor([-1.0, 2.0], device=dev), 1.0).tolist()
        [0.0, 2.0]
    """
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.all(x >= 0),
        projection_fn=proj_nonnegative_orthant,
    )


def Segment(dim_shape, a: float = 0.0, b: float = 1.0) -> IndicatorFunctional:
    """Indicator of ``a <= x <= b`` per coordinate.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import Segment
        >>> Segment((3,), 0.0, 1.0).prox(torch.tensor([-0.5, 0.5, 2.0], device=dev), 1.0).tolist()
        [0.0, 0.5, 1.0]
    """
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.all((x >= a) & (x <= b)),
        projection_fn=lambda x: proj_segment(x, a, b),
    )


def _is_real(x):
    x = torch.as_tensor(x)
    return torch.all(x.imag == 0) if x.is_complex() else torch.ones((), dtype=torch.bool, device=x.device)


def RealLine(dim_shape) -> IndicatorFunctional:
    """Indicator of real entries; prox = the real part.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import RealLine
        >>> RealLine((2,)).prox(torch.tensor([1.0 + 2.0j, 3.0], device=dev), 1.0).tolist()
        [1.0, 3.0]
    """
    return IndicatorFunctional(dim_shape, condition_fn=_is_real, projection_fn=lambda x: torch.as_tensor(x).real)


def _imag_part(x):
    x = torch.as_tensor(x)
    return 1j * x.imag if x.is_complex() else torch.zeros_like(x, dtype=torch.complex64)


def ImagLine(dim_shape) -> IndicatorFunctional:
    """Indicator of purely imaginary entries; prox = ``1j * imag(x)``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import ImagLine
        >>> ImagLine((1,)).prox(torch.tensor([1.0 + 2.0j], device=dev), 1.0).tolist()
        [2j]
    """
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: torch.all(torch.as_tensor(x).real == 0),
        projection_fn=_imag_part,
    )


class LogBarrier(ProximableFunctional):
    """``-sum log(x)`` (+inf where any ``x <= 0``): prox ``(x + sqrt(x^2 + 4 tau)) / 2``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import LogBarrier
        >>> f = LogBarrier((2,))
        >>> float(f(torch.tensor([1.0, 1.0], device=dev)))
        -0.0
        >>> [round(v, 4) for v in f.prox(torch.tensor([0.0, 3.0], device=dev), tau=1.0).tolist()]
        [1.0, 3.3028]
    """

    def __init__(self, dim_shape):
        super().__init__(dim_shape)

    def apply(self, x):
        x = torch.as_tensor(x)
        pos = x > 0
        y = torch.where(pos, torch.log(torch.where(pos, x, torch.ones_like(x))), torch.full_like(x, -_INF))
        return -torch.sum(y)

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        return (x + torch.sqrt(x**2 + 4 * tau)) / 2


class ShannonEntropy(ProximableFunctional):
    """Negative Shannon entropy ``sum x log x`` on ``x >= 0`` (+inf where
    any ``x < 0``): prox ``tau w`` with ``w + log w = x / tau - 1 -
    log(tau)``, 30 Newton steps with the 1e-30 floor (``tau
    W(exp(x/tau - 1)/tau)`` without an overflowing exponential).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import ShannonEntropy
        >>> f = ShannonEntropy((2,))
        >>> float(f(torch.tensor([1.0, 1.0], device=dev)))          # x log x = 0 at x = 1
        0.0
        >>> round(float(f.prox(torch.tensor([1.0], device=dev), tau=1.0)[0]), 5)
        0.56714
    """

    def __init__(self, dim_shape):
        super().__init__(dim_shape)

    def apply(self, x):
        x = torch.as_tensor(x)
        pos = x > 0
        xlogx = torch.where(pos, x * torch.log(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))
        val = torch.sum(xlogx)
        return torch.where(torch.any(x < 0), torch.full_like(val, _INF), val)

    def prox(self, x, tau):
        x = torch.as_tensor(x)
        log_tau = torch.log(tau) if isinstance(tau, torch.Tensor) else math.log(tau)
        s = x / tau - 1.0 - log_tau
        w = torch.where(s > 1.0, s - torch.log(torch.clamp(s, min=1.0)), torch.exp(torch.clamp(s, max=1.0)))
        w = torch.clamp(w, min=1e-30)
        for _ in range(30):
            g = w + torch.log(w) - s
            w = torch.clamp(w - g * w / (w + 1.0), min=1e-30)
        return tau * w


class QuadraticForm(DifferentiableFunctional):
    """``x^H L x`` for a symmetric PSD operator ``L``, or ``||x||^2`` when
    ``L`` is None: gradient ``2 L x``, beta ``2 L.diff_lipschitz``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.func.penalty import QuadraticForm
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator
        >>> f = QuadraticForm((2,), DiagonalOperator([1.0, 2.0]))
        >>> float(f(torch.tensor([1.0, 1.0], device=dev)))
        3.0
        >>> f.gradient(torch.tensor([1.0, 1.0], device=dev)).tolist()
        [2.0, 4.0]
    """

    def __init__(self, dim_shape, linop: Optional[LinearOperator] = None):
        beta = 2.0 if linop is None else 2.0 * linop.diff_lipschitz
        DifferentiableFunctional.__init__(self, dim_shape, lipschitz=_INF, diff_lipschitz=beta)
        self.linop = linop

    @property
    def device(self):
        return None if self.linop is None else self.linop.device

    def apply(self, x):
        x = torch.as_tensor(x)
        if self.linop is None:
            return _sqnorm(x)
        return torch.real(torch.vdot(x.reshape(-1), self.linop.apply(x).reshape(-1)))

    def jacobianT(self, x):
        x = torch.as_tensor(x)
        if self.linop is None:
            return 2 * x
        return 2 * self.linop.apply(x)
