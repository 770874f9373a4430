"""Orthonormal spectral transforms: FFT, DCT and inverse DCT (counterpart
of ``pycsou_tpu/ops/transform.py``).

Each is a ``UnitaryMixin`` operator: Lipschitz constant 1, Gram the
identity, ``pinv`` the adjoint, and a proximable functional composed with
one keeps its prox through the unitary precomposition rule.

``torch.fft`` has no DCT, so the DCT-II and DCT-III are built from a
length-2N real FFT as the reference's ``_dct2_1d_fft``/``_dct3_1d_fft`` do,
one path on every device.  The twiddle weights are complex tensors made
once, per transformed axis, on the operator's device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator, UnitaryMixin
from pycsou_tpu_torch.utils.device import resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["FFTOperator", "DCTOperator", "IDCTOperator"]


def _ortho_scale(n: int) -> np.ndarray:
    return np.concatenate([[1.0 / np.sqrt(n)], np.full(n - 1, np.sqrt(2.0 / n))])


def dct2_weights(n: int, device) -> torch.Tensor:
    """``0.5 c_k e^{-i pi k / (2n)}`` (``c`` the orthonormal scales): the
    DCT-II of ``x`` is ``Re(rfft([x, reversed(x)])[:n] * w)``."""
    k = np.arange(n)
    w = 0.5 * _ortho_scale(n) * np.exp(-1j * np.pi * k / (2 * n))
    return torch.from_numpy(w.astype(np.complex64)).to(device)


def dct3_weights(n: int, device) -> torch.Tensor:
    """The half spectrum's weights of the DCT-III: ``S_0 = 2n c_0 y_0``,
    ``S_k = n c_k e^{+i pi k / (2n)} y_k``; then ``x = irfft(S, 2n)[:n]``."""
    k = np.arange(n)
    c = _ortho_scale(n)
    w = n * c * np.exp(1j * np.pi * k / (2 * n))
    w[0] = 2.0 * n * c[0]
    return torch.from_numpy(w.astype(np.complex64)).to(device)


def dct2_1d(x: torch.Tensor, axis: int, w: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along ``axis`` (``w`` from :func:`dct2_weights`)."""
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    u = torch.cat([x, torch.flip(x, (-1,))], dim=-1)
    t = torch.real(torch.fft.rfft(u)[..., :n] * w)
    return torch.movedim(t.to(x.dtype), -1, axis)


def dct3_1d(y: torch.Tensor, axis: int, w: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III along ``axis``, the inverse of :func:`dct2_1d`
    (``w`` from :func:`dct3_weights`)."""
    n = y.shape[axis]
    y = torch.movedim(y, axis, -1)
    spec = torch.cat([y * w, torch.zeros(y.shape[:-1] + (1,), dtype=w.dtype, device=y.device)], dim=-1)
    x = torch.fft.irfft(spec, n=2 * n)[..., :n]
    return torch.movedim(x.to(y.dtype), -1, axis)


class _DCTBase(UnitaryMixin, LinearOperator):
    """Holds the axes and, per axis, the DCT-II and DCT-III weights."""

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None, dtype=torch.float32, device=None):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)
        self.axes = tuple(axes) if axes is not None else None
        dev = resolve_device(device)
        todo: Tuple[int, ...] = self.axes if self.axes is not None else tuple(range(len(dim_shape)))
        self._w2 = [(a, dct2_weights(dim_shape[a], dev)) for a in todo]
        self._w3 = [(a, dct3_weights(dim_shape[a], dev)) for a in todo]

    @property
    def device(self):
        return self._w2[0][1].device if self._w2 else None

    def _dct(self, x):
        for a, w in self._w2:
            x = dct2_1d(x, a, w)
        return x.to(self.dtype)

    def _idct(self, y):
        y = torch.as_tensor(y)
        for a, w in self._w3:
            y = dct3_1d(y, a, w)
        return y.to(self.dtype)


class DCTOperator(_DCTBase):
    """Orthonormal DCT-II over ``axes`` (all when None); the adjoint is the
    inverse DCT (DCT-III).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.transform import DCTOperator
        >>> D = DCTOperator((4,))
        >>> [round(v, 6) for v in D(torch.ones(4, device=dev)).tolist()]
        [2.0, 0.0, 0.0, 0.0]
    """

    def apply(self, x):
        return self._dct(x)

    def adjoint(self, y):
        return self._idct(y)


class IDCTOperator(_DCTBase):
    """Orthonormal inverse DCT (synthesis: coefficients to signal).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.transform import IDCTOperator
        >>> S = IDCTOperator((4,))
        >>> [round(v, 6) for v in S(torch.tensor([2.0, 0.0, 0.0, 0.0], device=dev)).tolist()]   # DC -> constant
        [1.0, 1.0, 1.0, 1.0]
    """

    def apply(self, x):
        return self._idct(x)

    def adjoint(self, y):
        return self._dct(torch.as_tensor(y))


class FFTOperator(UnitaryMixin, LinearOperator):
    """Orthonormal n-dimensional DFT (complex to complex, ``norm='ortho'``)
    over ``axes`` (all when None).  Holds no tensors: it acts on the device
    of its input.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.transform import FFTOperator
        >>> F = FFTOperator((4,))
        >>> x = torch.tensor([1.0, 2.0, 3.0, 4.0], device=dev).to(torch.complex64)
        >>> bool(torch.allclose(F.adjoint(F(x)), x, atol=1e-6))
        True
    """

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None, dtype=torch.complex64):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)
        self.axes = tuple(axes) if axes is not None else None

    def apply(self, x):
        return torch.fft.fftn(x, dim=self.axes, norm="ortho").to(self.dtype)

    def adjoint(self, y):
        return torch.fft.ifftn(torch.as_tensor(y), dim=self.axes, norm="ortho").to(self.dtype)
