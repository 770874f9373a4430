"""Green functions and radial basis kernels: Matern, Wendland, the causal
Green functions and sub-Gaussians (counterpart of
``pycsou_tpu/math/green.py``).

Each kernel is a callable on tensors (or arrays and scalars, taken as
float32 CPU tensors), computed elementwise on the input's device, so
that ``MappedDistanceMatrix`` evaluates it where its distances are.
``Wendland.support`` is a property (the reference's fix of the original
library's attribute/method collision)."""
from __future__ import annotations

import math

import torch

__all__ = [
    "Matern",
    "Wendland",
    "CausalGreenIteratedDerivative",
    "CausalGreenExponential",
    "SubGaussian",
]


def _tensor(r) -> torch.Tensor:
    return r if isinstance(r, torch.Tensor) else torch.as_tensor(r, dtype=torch.float32)


class Matern:
    """Matern radial kernel of half-integer order ``k`` in {0, 1, 2, 3}
    (``k + 1/2``) and scale ``epsilon``."""

    def __init__(self, k: int = 0, epsilon: float = 1.0):
        if k not in (0, 1, 2, 3):
            raise ValueError("k must be in {0, 1, 2, 3}")
        self.k = int(k)
        self.epsilon = float(epsilon)

    def __call__(self, r):
        r = _tensor(r)
        e = self.epsilon
        if self.k == 0:
            return torch.exp(-r / e)
        if self.k == 1:
            s = math.sqrt(3)
            return (1 + s * r / e) * torch.exp(-s * r / e)
        if self.k == 2:
            s = math.sqrt(5)
            return (1 + s * r / e + (5 * r**2) / (3 * e**2)) * torch.exp(-s * r / e)
        s = math.sqrt(7)
        return (
            1 + s * r / e + (42 * r**2) / (15 * e**2) + (7 * s * r**3) / (15 * e**3)
        ) * torch.exp(-s * r / e)

    def support(self, sigmas: float = 3.0) -> float:
        """Effective support radius: ``sigmas * epsilon``."""
        return sigmas * self.epsilon


class Wendland:
    """Compactly supported Wendland kernels, ``k`` in {0, 1, 2, 3}, of
    support radius ``epsilon``."""

    def __init__(self, k: int = 0, epsilon: float = 1.0):
        if k not in (0, 1, 2, 3):
            raise ValueError("k must be in {0, 1, 2, 3}")
        self.k = int(k)
        self.epsilon = float(epsilon)

    @property
    def support(self) -> float:
        """The compact support radius ``epsilon``."""
        return self.epsilon

    def __call__(self, r):
        r = _tensor(r)
        e = self.epsilon
        t = torch.clamp(1 - r / e, min=0.0)
        if self.k == 0:
            return t**2
        if self.k == 1:
            return t**4 * (1 + 4 * r / e)
        if self.k == 2:
            return t**6 * (1 + 6 * r / e + 35 * r**2 / (3 * e**2))
        return t**8 * (1 + 8 * r / e + 25 * r**2 / e**2 + 32 * r**3 / e**3)


class CausalGreenIteratedDerivative:
    """Green function of ``D^k``: ``x^(k-1) 1_{x >= 0}`` (without the
    ``1/(k-1)!``, as in the reference)."""

    def __init__(self, k: int = 1):
        self.k = int(k)

    def __call__(self, x):
        x = _tensor(x)
        return torch.where(x >= 0, x ** (self.k - 1), torch.zeros_like(x))


class CausalGreenExponential:
    """Green function of ``(D + alpha I)^k``: ``x^(k-1) exp(-alpha x) 1_{x >= 0}``."""

    def __init__(self, k: int = 1, alpha: float = 1.0):
        self.k = int(k)
        self.alpha = float(alpha)

    def __call__(self, x):
        x = _tensor(x)
        val = x ** (self.k - 1) * torch.exp(-self.alpha * torch.clamp(x, min=0.0))
        return torch.where(x >= 0, val, torch.zeros_like(x))


class SubGaussian:
    """``exp(-r^alpha / epsilon)`` for ``alpha`` in (0, 2]."""

    def __init__(self, alpha: float = 1.0, epsilon: float = 1.0):
        if not 0 < alpha <= 2:
            raise ValueError("alpha must be in (0, 2]")
        self.alpha = float(alpha)
        self.epsilon = float(epsilon)

    def __call__(self, r):
        r = _tensor(r)
        return torch.exp(-(r**self.alpha) / self.epsilon)
