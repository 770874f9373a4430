"""Sampling operators of the masked TV slice (counterpart of
``pycsou_tpu/ops/sampling.py``): restriction to flat indices, boolean
masking and strided downsampling.

Each is a gather whose adjoint scatters back onto a zero image, so its
Gram ``A^H A`` is the diagonal ``A^H 1`` (the per-pixel sample count):
``opt/fuse.py`` hands that diagonal to ``TVDeconvolution``'s mask mode.
The adjoints are the reference's exactly: ``Masking`` *sets* the values,
``SubSampling`` *adds* them (a repeated index counts twice), and
``DownSampling`` zero-upsamples onto the ``ceil(n / f)``-per-axis grid.
``Pooling``, ``NNSampling``, ``GeneralisedVandermonde`` and
``MappedDistanceMatrix`` wait for ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.utils.device import resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["SubSampling", "Masking", "DownSampling"]


class SubSampling(LinearOperator):
    """Restriction to a set of flat indices; the adjoint adds each sample
    back at its index (``index_add_``), so repeated indices accumulate.

    On a CUDA device ``index_add_`` adds in no fixed order: sample counts
    (sums of 1.0) are exact, the back-projection of data with repeated
    indices may differ in the last bit from run to run."""

    def __init__(self, dim_shape, indices, dtype=torch.float32, device=None):
        dim_shape = as_shape(dim_shape)
        dev = resolve_device(device, indices)
        if isinstance(indices, torch.Tensor):
            idx = indices.reshape(-1).to(device=dev, dtype=torch.long)
        else:
            idx = torch.as_tensor(np.asarray(indices).reshape(-1), dtype=torch.long, device=dev)
        super().__init__(dim_shape, (idx.numel(),), lipschitz=1.0, dtype=dtype)
        self.indices = idx

    @property
    def device(self):
        return self.indices.device

    def apply(self, x):
        return x.reshape(-1).index_select(0, self.indices)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        flat = torch.zeros(self.dim, dtype=y.dtype, device=y.device)
        return flat.index_add_(0, self.indices, y.reshape(-1)).reshape(self.dim_shape)


class Masking(LinearOperator):
    """Gather of the pixels where a boolean mask is true; the adjoint sets
    them back onto a zero image (``index_copy_``)."""

    def __init__(self, dim_shape, mask, dtype=torch.float32, device=None):
        dim_shape = as_shape(dim_shape)
        dev = resolve_device(device, mask)
        if isinstance(mask, torch.Tensor):
            keep = mask.to(device=dev, dtype=torch.bool)
        else:
            keep = torch.as_tensor(np.asarray(mask, dtype=bool), device=dev)
        if tuple(keep.shape) != dim_shape:
            raise ValueError(f"mask shape {tuple(keep.shape)} != dim_shape {dim_shape}")
        idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
        super().__init__(dim_shape, (idx.numel(),), lipschitz=1.0, dtype=dtype)
        self.indices = idx
        self._mask = keep

    @property
    def device(self):
        return self.indices.device

    @property
    def mask(self) -> torch.Tensor:
        """The boolean keep-mask this operator samples with."""
        return self._mask

    def apply(self, x):
        return x.reshape(-1).index_select(0, self.indices)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        flat = torch.zeros(self.dim, dtype=y.dtype, device=y.device)
        return flat.index_copy_(0, self.indices, y.reshape(-1)).reshape(self.dim_shape)


class DownSampling(LinearOperator):
    """Keep one sample every ``factor`` along each axis (or along ``axis``
    only); the adjoint zero-upsamples.  The codomain has ``ceil(n / f)``
    samples per axis.  Holds no tensors: it acts on the device of its
    input."""

    def __init__(self, dim_shape, factor: Union[int, Sequence[int]], axis: Optional[int] = None,
                 dtype=torch.float32):
        dim_shape = as_shape(dim_shape)
        d = len(dim_shape)
        if np.isscalar(factor):
            factors = [1] * d
            if axis is None:
                factors = [int(factor)] * d
            else:
                factors[axis] = int(factor)
        else:
            factors = [int(f) for f in factor]
        if len(factors) != d or min(factors) < 1:
            raise ValueError(f"factors {factors}: need {d} positive integers")
        codim = tuple((n + f - 1) // f for n, f in zip(dim_shape, factors))
        super().__init__(dim_shape, codim, lipschitz=1.0, dtype=dtype)
        self.factors = tuple(factors)

    def _slices(self):
        return tuple(slice(None, None, f) for f in self.factors)

    def apply(self, x):
        return x[self._slices()].contiguous()

    def adjoint(self, y):
        y = torch.as_tensor(y)
        out = torch.zeros(self.dim_shape, dtype=y.dtype, device=y.device)
        out[self._slices()] = y
        return out
