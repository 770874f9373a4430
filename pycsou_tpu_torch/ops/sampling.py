"""Sampling operators (counterpart of ``pycsou_tpu/ops/sampling.py``):
restriction to flat indices, boolean masking, strided downsampling, block
pooling, off-grid nearest-neighbour sampling, the generalised Vandermonde
matrix and mapped distance (kernel) matrices.

``SubSampling``, ``Masking`` and ``DownSampling`` are gathers whose
adjoints scatter back onto a zero image, so their Gram ``A^H A`` is the
diagonal ``A^H 1`` (the per-pixel sample count): ``opt/fuse.py`` hands that
diagonal to ``TVDeconvolution``'s mask mode.  The adjoints are the
reference's exactly: ``Masking`` *sets* the values, ``SubSampling`` *adds*
them (a repeated index counts twice), and ``DownSampling`` zero-upsamples
onto the ``ceil(n / f)``-per-axis grid.

Index sets (``NNSampling``'s nearest nodes, the sparse
``MappedDistanceMatrix``'s neighbour lists) come from a host
``scipy.spatial.cKDTree`` once, at construction; every apply and adjoint is
device work (gathers, ``index_add``, matrix products in full f32).  On the
card ``index_add`` adds in no fixed order.  Every operator here runs under
``torch.func.vmap`` (``batchable``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.ops.basic import DenseOperator
from pycsou_tpu_torch.utils.device import as_tensor, full_f32, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape, size_of

__all__ = [
    "SubSampling",
    "Masking",
    "DownSampling",
    "Pooling",
    "NNSampling",
    "GeneralisedVandermonde",
    "MappedDistanceMatrix",
]


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


class Pooling(LinearOperator):
    """Block sum or mean pooling; the adjoint unpools (each block's value
    repeated over it, divided by the block's volume for ``'mean'``).

    A block that does not divide an axis pads it at the trailing edge with
    zeros, as skimage's ``block_reduce(cval=0)`` does: ``'mean'`` divides by
    the full block volume, padding included.  Holds no tensors: it acts on
    the device of its input."""

    def __init__(self, dim_shape, block_size, kind: str = "mean", dtype=torch.float32):
        dim_shape = as_shape(dim_shape)
        bs = tuple(int(b) for b in ([block_size] * len(dim_shape) if np.isscalar(block_size) else block_size))
        if len(bs) != len(dim_shape):
            raise ValueError("block_size rank must match dim_shape")
        if kind not in ("sum", "mean"):
            raise ValueError("kind must be 'sum' or 'mean'")
        padded = tuple(-(-n // b) * b for n, b in zip(dim_shape, bs))
        codim = tuple(p // b for p, b in zip(padded, bs))
        vol = math.prod(bs)
        super().__init__(dim_shape, codim, lipschitz=math.sqrt(vol) if kind == "sum" else 1.0 / math.sqrt(vol),
                         dtype=dtype)
        self.block_size = bs
        self.kind = kind
        self._padded = padded

    def apply(self, x):
        if self._padded != self.dim_shape:
            pads = []
            for n, p in zip(reversed(self.dim_shape), reversed(self._padded)):
                pads += [0, p - n]
            x = F.pad(x, pads)
        shape = []
        for p, b in zip(self._padded, self.block_size):
            shape += [p // b, b]
        out = torch.sum(x.reshape(shape), dim=tuple(range(1, len(shape), 2)))
        if self.kind == "mean":
            out = out / math.prod(self.block_size)
        return out

    def adjoint(self, y):
        y = torch.as_tensor(y)
        if self.kind == "mean":
            y = y / math.prod(self.block_size)
        for i, b in enumerate(self.block_size):
            y = torch.repeat_interleave(y, b, dim=i)
        if self._padded != self.dim_shape:
            y = y[tuple(slice(0, n) for n in self.dim_shape)]
        return y


def _points(a) -> np.ndarray:
    """Coordinates as a float64 ``(n, d)`` numpy array (1-D: ``d = 1``)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a = np.asarray(a, dtype=np.float64)
    return a[:, None] if a.ndim == 1 else a


class NNSampling(LinearOperator):
    """Off-grid nearest-neighbour sampling: each sample takes the value of
    its nearest grid node, found once by a host ``cKDTree``; ``apply`` is a
    gather.  The adjoint adds each sample back onto its node
    (``index_add``) and, with ``adjoint_mode='mean'`` (the reference's
    default, its original's averaging of colliding samples), divides by the
    node's sample count; ``'sum'`` is the true adjoint.  The indices and
    counts live on ``device`` (else the coordinates' device, else the
    port's default)."""

    def __init__(self, grid_coords, sample_coords, dim_shape=None, adjoint_mode: str = "mean",
                 dtype=torch.float32, device=None):
        from scipy.spatial import cKDTree

        if adjoint_mode not in ("mean", "sum"):
            raise ValueError("adjoint_mode must be 'mean' or 'sum'")
        dev = resolve_device(device, grid_coords, sample_coords)
        grid, samples = _points(grid_coords), _points(sample_coords)
        _, idx = cKDTree(grid).query(samples)
        n_grid = grid.shape[0]
        dim_shape = as_shape(dim_shape) if dim_shape is not None else (n_grid,)
        if size_of(dim_shape) != n_grid:
            raise ValueError("dim_shape size must equal the number of grid nodes")
        super().__init__(dim_shape, (samples.shape[0],), lipschitz=float("inf"), dtype=dtype)
        self.indices = torch.as_tensor(idx, dtype=torch.long, device=dev)
        counts = np.maximum(np.bincount(idx, minlength=n_grid).astype(np.float32), 1.0)
        self.counts = torch.as_tensor(counts, device=dev)
        self.adjoint_mode = adjoint_mode

    @property
    def device(self):
        return self.indices.device

    def apply(self, x):
        return x.reshape(-1).index_select(0, self.indices)

    def adjoint(self, y):
        y = torch.as_tensor(y).reshape(-1)
        summed = torch.zeros(self.dim, dtype=y.dtype, device=y.device).index_add(0, self.indices, y)
        if self.adjoint_mode == "mean":
            summed = summed / self.counts
        return summed.reshape(self.dim_shape)


def GeneralisedVandermonde(funcs: Sequence[Callable], samples, dtype=torch.float32, device=None) -> DenseOperator:
    """The port's :class:`~pycsou_tpu_torch.ops.basic.DenseOperator` of
    ``[phi_k(z_l)]``: each function of the dictionary evaluated on the
    float32 samples (a tensor in, a tensor out) on ``device``."""
    dev = resolve_device(device, samples)
    z = as_tensor(samples, dev)
    cols = [torch.as_tensor(f(z)).reshape(-1) for f in funcs]
    return DenseOperator(torch.stack(cols, dim=1).to(dtype))


class MappedDistanceMatrix(LinearOperator):
    """Kernel matrix operator ``y_i = sum_j phi(d(z_i, x_j)) a_j`` between
    ``samples1`` (rows) and ``samples2`` (columns).

    ``mode='radial'`` takes the Euclidean distance ``sqrt(sum((a - b)^2))``
    (computed directly, not through a matrix product), ``'zonal'`` the dot
    product of the points (for spherical kernels).  Backends:

    * ``'dense'``: the kernel matrix built once on the device;
    * ``'sparse'``: compact-support kernels.  A host ``cKDTree`` ball query
      of radius ``support`` (else ``function.support``) gives each row its
      neighbours once, padded to the longest list (``kmax``); the apply is
      a gather and a masked contraction, the adjoint an ``index_add``.
      Radial only, as in the reference;
    * ``'matrix-free'``: the kernel rows recomputed ``block`` rows at a time
      inside each apply and adjoint.

    Points and tables live on ``device`` (else the points' device, else the
    port's default); products run in full f32."""

    def __init__(self, samples1, samples2, function: Callable, mode: str = "radial", backend: str = "dense",
                 block: int = 1024, support: Optional[float] = None, dtype=torch.float32, device=None):
        if mode not in ("radial", "zonal"):
            raise ValueError("mode must be 'radial' or 'zonal'")
        if backend not in ("dense", "sparse", "matrix-free"):
            raise ValueError("backend must be 'dense', 'sparse' or 'matrix-free'")
        dev = resolve_device(device, samples1, samples2)
        s1, s2 = as_tensor(samples1, dev, dtype), as_tensor(samples2, dev, dtype)
        s1 = s1[:, None] if s1.ndim == 1 else s1
        s2 = s2[:, None] if s2.ndim == 1 else s2
        super().__init__((s2.shape[0],), (s1.shape[0],), lipschitz=float("inf"), dtype=dtype)
        self.samples1, self.samples2 = s1, s2
        self.function = function
        self.mode = mode
        self.backend = backend
        self.block = int(block)
        self._mat = self._nbr_idx = self._nbr_val = None
        if backend == "dense":
            self._mat = self._kernel_block(s1)
        elif backend == "sparse":
            if mode != "radial":
                raise ValueError("sparse backend requires mode='radial'")
            r = support if support is not None else getattr(function, "support", None)
            if r is None:
                raise ValueError("sparse backend needs `support` (kernel support radius)")
            self._nbr_idx, self._nbr_val = self._neighbours(float(r))

    @property
    def device(self):
        return self.samples1.device

    def _neighbours(self, r: float):
        """Padded ``(m, kmax)`` neighbour indices and kernel values: one host
        ball query, one distance computation and one kernel evaluation over
        every in-support pair."""
        from scipy.spatial import cKDTree

        s1 = self.samples1.cpu().numpy().astype(np.float64)
        s2 = self.samples2.cpu().numpy().astype(np.float64)
        lists = cKDTree(s2).query_ball_point(s1, r=r)
        m = s1.shape[0]
        lens = np.fromiter((len(l) for l in lists), np.int64, count=m)
        kmax = max(1, int(lens.max()) if m else 1)
        idx = np.zeros((m, kmax), np.int64)
        val = np.zeros((m, kmax), np.float32)
        if lens.sum():
            rows = np.repeat(np.arange(m), lens)
            cols = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
            flat_idx = np.concatenate([np.asarray(l, np.int64) for l in lists if l])
            d = np.sqrt(np.sum((s1[rows] - s2[flat_idx]) ** 2, axis=-1))
            idx[rows, cols] = flat_idx
            val[rows, cols] = self.function(torch.from_numpy(d.astype(np.float32))).numpy()
        dev = self.samples1.device
        return torch.as_tensor(idx, device=dev), torch.as_tensor(val, dtype=self.dtype, device=dev)

    def _kernel_block(self, pts):
        if self.mode == "radial":
            diff = pts[:, None, :] - self.samples2[None, :, :]
            d = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=0.0))
        else:
            with full_f32():
                d = pts @ self.samples2.T
        return self.function(d).to(self.dtype)

    def _row_blocks(self):
        m = self.samples1.shape[0]
        return [(i, self.samples1[i : i + self.block]) for i in range(0, m, self.block)]

    def apply(self, x):
        if self.backend == "sparse":
            m, kmax = self._nbr_idx.shape
            g = x.reshape(-1).index_select(0, self._nbr_idx.reshape(-1)).reshape(m, kmax)
            return torch.sum(self._nbr_val * g, dim=1)
        with full_f32():
            if self.backend == "dense":
                return self._mat @ x
            return torch.cat([self._kernel_block(b) @ x for _, b in self._row_blocks()])

    def adjoint(self, y):
        y = torch.as_tensor(y)
        if self.backend == "sparse":
            contrib = (self._nbr_val * y[:, None]).reshape(-1)
            out = torch.zeros(self.dim, dtype=contrib.dtype, device=contrib.device)
            return out.index_add(0, self._nbr_idx.reshape(-1), contrib)
        with full_f32():
            if self.backend == "dense":
                return self._mat.T @ y
            parts = [self._kernel_block(b).T @ y[i : i + b.shape[0]] for i, b in self._row_blocks()]
        return torch.stack(parts).sum(0)

    def todense(self):
        return DenseOperator(self._mat if self.backend == "dense" else self._kernel_block(self.samples1))
