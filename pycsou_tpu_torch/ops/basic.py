"""Structural operators: dense, sparse, diagonal, identity, null,
homothety and polynomial (counterpart of ``pycsou_tpu/ops/basic.py``).

``DenseOperator``'s products run in full IEEE f32 (``full_f32``), as the
reference accumulates in f32 where the card would otherwise take TF32.
``SparseOperator`` holds a CSR tensor and its transpose, built once, for
the adjoint: cuSPARSE/cuBLAS products where the JAX package also computes
outside any Pallas kernel.  Each constructor that takes an array puts it
on ``device=``, else the array's device, else the port's default.
"""
from __future__ import annotations

import warnings
from numbers import Number

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator, SelfAdjointMixin
from pycsou_tpu_torch.utils.device import as_tensor, dtype_of, full_f32, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape, size_of

__all__ = [
    "DenseOperator",
    "ExplicitLinearOperator",
    "SparseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "NullOperator",
    "HomothetyOperator",
    "PolynomialOperator",
]

_INF = float("inf")
_EXACT_NORM_MAX = 4_000_000  # entries up to which DenseOperator.opnorm takes the exact norm


def _shapes(dim_shape, codim_shape, n_rows, n_cols):
    dim_shape = as_shape(dim_shape) if dim_shape is not None else (n_cols,)
    codim_shape = as_shape(codim_shape) if codim_shape is not None else (n_rows,)
    if size_of(dim_shape) != n_cols or size_of(codim_shape) != n_rows:
        raise ValueError("dim/codim shapes inconsistent with mat")
    return dim_shape, codim_shape


class DenseOperator(LinearOperator):
    """Matrix-backed operator: ``mat`` is ``(codim_size, dim_size)``; inputs
    are flattened, outputs reshaped; the products run in full f32.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DenseOperator
        >>> A = DenseOperator([[1.0, 2.0], [3.0, 4.0]])
        >>> A(torch.tensor([1.0, 1.0], device=dev)).tolist()
        [3.0, 7.0]
        >>> A.adjoint(torch.tensor([1.0, 0.0], device=dev)).tolist()   # A^T e_0 = row 0 of A
        [1.0, 2.0]
    """

    def __init__(self, mat, dim_shape=None, codim_shape=None, dtype=None, device=None):
        dev = resolve_device(device, mat)
        mat = as_tensor(mat, dev, dtype_of(mat) if dtype is None else dtype)
        if mat.ndim != 2:
            raise ValueError("mat must be 2-D; use dim_shape/codim_shape for nd domains")
        dim_shape, codim_shape = _shapes(dim_shape, codim_shape, *mat.shape)
        super().__init__(dim_shape, codim_shape, dtype=mat.dtype)
        self.mat = mat

    @property
    def device(self):
        return self.mat.device

    def apply(self, x):
        with full_f32():
            y = self.mat @ x.reshape(-1).to(self.dtype)
        return y.reshape(self.codim_shape)

    def adjoint(self, y):
        with full_f32():
            x = torch.conj(self.mat).T @ torch.as_tensor(y).reshape(-1).to(self.dtype)
        return x.reshape(self.dim_shape)

    def todense(self):
        return self

    def opnorm(self, exact: bool = True, **kwargs) -> float:
        """The exact spectral norm (the largest of ``torch.linalg.svdvals``)
        up to 4e6 entries, else the power iteration.  On the card the SVD is
        cuSOLVER's QR-based ``gesvd``: its default driver was 4.4e-4 off a
        known norm of 6.0 at 4096 x 4096 (PERF.md, PR 15)."""
        if exact and self.dim * self.codim <= _EXACT_NORM_MAX:
            driver = "gesvd" if self.mat.is_cuda else None
            return float(torch.linalg.svdvals(self.mat, driver=driver)[0])
        return super().opnorm(**kwargs)


#: Reference-compatible alias
ExplicitLinearOperator = DenseOperator


def _csr(rows, cols, vals, shape):
    """The CSR tensor of a COO matrix (duplicates summed)."""
    with warnings.catch_warnings():  # PyTorch's notices: CSR support in beta, invariant checks off
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
        warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape, check_invariants=True)
        return coo.coalesce().to_sparse_csr()


class SparseOperator(LinearOperator):
    """Sparse-matrix operator: a scipy sparse matrix or a dense array,
    held as a CSR tensor with its transpose (built once) for the
    adjoint.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> import scipy.sparse as sp
        >>> from pycsou_tpu_torch.ops.basic import SparseOperator
        >>> A = SparseOperator(sp.csr_matrix([[2.0, 0.0], [0.0, 0.0]]))
        >>> A(torch.tensor([1.0, 5.0], device=dev)).tolist()
        [2.0, 0.0]
    """

    def __init__(self, mat, dim_shape=None, codim_shape=None, device=None):
        import scipy.sparse as sp

        dev = resolve_device(device, mat)
        if sp.issparse(mat):
            coo = mat.tocoo()
            dtype = dtype_of(coo.data)
            rows = torch.from_numpy(coo.row.astype(np.int64))
            cols = torch.from_numpy(coo.col.astype(np.int64))
            vals = as_tensor(coo.data, "cpu", dtype)
            shape = coo.shape
        else:
            dense = as_tensor(mat, dev, dtype_of(mat))
            rows, cols = torch.nonzero(dense, as_tuple=True)
            vals, shape, dtype = dense[rows, cols], tuple(dense.shape), dense.dtype
        rows, cols, vals = rows.to(dev), cols.to(dev), vals.to(dev)
        self.mat = _csr(rows, cols, vals, shape)
        self.mat_t = _csr(cols, rows, vals, shape[::-1])
        dim_shape, codim_shape = _shapes(dim_shape, codim_shape, *shape)
        super().__init__(dim_shape, codim_shape, dtype=dtype)

    @property
    def device(self):
        return self.mat.device

    def apply(self, x):
        return torch.mv(self.mat, x.reshape(-1).to(self.dtype)).reshape(self.codim_shape)

    def adjoint(self, y):
        y = torch.conj(torch.as_tensor(y).reshape(-1).to(self.dtype))
        return torch.conj_physical(torch.mv(self.mat_t, y)).reshape(self.dim_shape)


class DiagonalOperator(SelfAdjointMixin, LinearOperator):
    """Elementwise multiplication by ``diag``; ``lipschitz = max |diag|``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator
        >>> D = DiagonalOperator([1.0, -2.0])
        >>> D(torch.tensor([3.0, 3.0], device=dev)).tolist()
        [3.0, -6.0]
        >>> D.lipschitz          # max |diag|
        2.0
    """

    def __init__(self, diag, dtype=None, device=None):
        dev = resolve_device(device, diag)
        diag = as_tensor(diag, dev, dtype_of(diag) if dtype is None else dtype)
        lip = float(torch.max(torch.abs(diag))) if diag.numel() else _INF
        super().__init__(tuple(diag.shape), tuple(diag.shape), lipschitz=lip, dtype=diag.dtype)
        self.diag = diag

    @property
    def device(self):
        return self.diag.device

    def apply(self, x):
        return self.diag * x

    def adjoint(self, y):
        return torch.conj(self.diag) * torch.as_tensor(y)


class IdentityOperator(SelfAdjointMixin, LinearOperator):
    """Identity.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import IdentityOperator
        >>> IdentityOperator((2,))(torch.tensor([1.0, 2.0], device=dev)).tolist()
        [1.0, 2.0]
    """

    def __init__(self, dim_shape, dtype=torch.float32):
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)

    def apply(self, x):
        return x

    def opnorm(self, **kwargs):
        return 1.0

    def pinv(self, y, **kwargs):
        return torch.as_tensor(y)

    pinv_batched = pinv  # elementwise: a batch is one call


class NullOperator(LinearOperator):
    """Maps everything to zero.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import NullOperator
        >>> NullOperator((2,), (3,))(torch.tensor([1.0, 2.0], device=dev)).tolist()
        [0.0, 0.0, 0.0]
    """

    def __init__(self, dim_shape, codim_shape=None, dtype=torch.float32):
        codim_shape = codim_shape if codim_shape is not None else dim_shape
        super().__init__(dim_shape, codim_shape, lipschitz=0.0, dtype=dtype)

    def apply(self, x):
        return torch.zeros(self.codim_shape, dtype=x.dtype, device=x.device)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return torch.zeros(self.dim_shape, dtype=y.dtype, device=y.device)

    def opnorm(self, **kwargs):
        return 0.0


class HomothetyOperator(SelfAdjointMixin, LinearOperator):
    """Scalar scaling ``x -> c x``; the node injected by scalar arithmetic.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import HomothetyOperator, IdentityOperator
        >>> (3.0 * IdentityOperator((2,)))(torch.tensor([1.0, 2.0], device=dev)).tolist()
        [3.0, 6.0]
        >>> HomothetyOperator(3.0, (2,))(torch.tensor([1.0, 2.0], device=dev)).tolist()
        [3.0, 6.0]
    """

    def __init__(self, constant, dim_shape, dtype=torch.float32):
        if not isinstance(constant, Number):
            raise TypeError("HomothetyOperator constant must be a scalar")
        super().__init__(dim_shape, dim_shape, lipschitz=abs(constant), dtype=dtype)
        self.constant = constant

    def apply(self, x):
        return self.constant * x

    def adjoint(self, y):
        return self.constant.conjugate() * torch.as_tensor(y)

    def opnorm(self, **kwargs):
        return abs(self.constant)

    def pinv(self, y, **kwargs):
        return torch.as_tensor(y) / self.constant

    pinv_batched = pinv  # elementwise: a batch is one call


class PolynomialOperator(LinearOperator):
    """``P(L) = sum_k a_k L^k`` of a square operator by Horner's scheme;
    ``coeffs`` a sequence or numpy array (float32, or complex64 when
    complex, as in the reference).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator, PolynomialOperator
        >>> D = DiagonalOperator([1.0, 2.0])
        >>> P = PolynomialOperator(D, coeffs=[1.0, 0.0, 2.0])     # I + 2 D^2
        >>> P(torch.tensor([1.0, 1.0], device=dev)).tolist()
        [3.0, 9.0]
    """

    def __init__(self, base: LinearOperator, coeffs):
        if base.dim_shape != base.codim_shape:
            raise ValueError("PolynomialOperator requires a square operator")
        c = np.asarray(coeffs.cpu() if isinstance(coeffs, torch.Tensor) else coeffs)
        c = c.astype(np.complex64 if np.iscomplexobj(c) else np.float32)
        lip = _INF
        if base.lipschitz < _INF:
            lip = float(sum(ck * base.lipschitz**k for k, ck in enumerate(np.abs(c))))
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=lip, dtype=base.dtype)
        self.base = base
        self.coeffs = [complex(ck) if np.iscomplexobj(c) else float(ck) for ck in c]

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        n = len(self.coeffs)
        y = self.coeffs[n - 1] * x
        for k in range(n - 2, -1, -1):
            y = self.base.apply(y) + self.coeffs[k] * x
        return y

    def adjoint(self, y):
        y = torch.as_tensor(y)
        c = [ck.conjugate() for ck in self.coeffs]
        n = len(c)
        x = c[n - 1] * y
        for k in range(n - 2, -1, -1):
            x = self.base.adjoint(x) + c[k] * y
        return x
