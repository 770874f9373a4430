"""Kronecker-structured operators: the matrix-free Kronecker product and sum,
and the Khatri-Rao product (counterpart of ``pycsou_tpu/ops/kron.py``).

Row-major (C-order) vec, as ``np.kron``: ``(A kron B) x == (A @ X @ B.T)
.ravel()`` for ``X = x.reshape(nA, nB)``.  A dense factor acts on every row
or column of ``X`` in one ``torch.matmul`` under ``full_f32``; another
operator through its ``apply_batched``/``adjoint_batched``.
"""
from __future__ import annotations

import numpy as np
import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.ops.basic import DenseOperator
from pycsou_tpu_torch.utils.device import as_tensor, dtype_of, full_f32, resolve_device

__all__ = ["KroneckerProduct", "KroneckerSum", "KhatriRaoProduct"]


def _as_op(x, device) -> LinearOperator:
    """An operator as it is; an array as a DenseOperator on ``device``."""
    return x if isinstance(x, LinearOperator) else DenseOperator(x, device=device)


def _rows(op: LinearOperator, M: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """``op`` (or its adjoint) applied to every row of ``M``."""
    if isinstance(op, DenseOperator):
        mat = torch.conj(op.mat).T if adjoint else op.mat
        with full_f32():
            return M.to(op.dtype) @ mat.T
    return op.adjoint_batched(M) if adjoint else op.apply_batched(M)


def _cols(op: LinearOperator, M: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """``op`` (or its adjoint) applied to every column of ``M``."""
    return _rows(op, M.T, adjoint).T


def _dtype(A, B):
    return torch.promote_types(A.dtype, B.dtype)


class KroneckerProduct(LinearOperator):
    """``A kron B`` by the vec trick: forward ``A X B^T``, adjoint
    ``A^H Y conj(B)``, ``pinv = A^+ kron B^+``, ``L = L_A L_B``.  A factor
    given as an array becomes a DenseOperator on ``device``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DenseOperator
        >>> from pycsou_tpu_torch.ops.kron import KroneckerProduct
        >>> A = torch.tensor([[1.0, 2.0], [0.0, 1.0]], device=dev)
        >>> B = torch.tensor([[0.0, 1.0], [1.0, 0.0]], device=dev)
        >>> K = KroneckerProduct(DenseOperator(A), DenseOperator(B))
        >>> x = torch.arange(4.0, device=dev)
        >>> bool(torch.allclose(K(x).reshape(-1), torch.kron(A, B) @ x))
        True
    """

    def __init__(self, A, B, device=None):
        A, B = _as_op(A, device), _as_op(B, device)
        if len(A.dim_shape) != 1 or len(B.dim_shape) != 1:
            raise ValueError("Kronecker factors must be 1-D operators")
        super().__init__((A.dim, B.dim), (A.codim, B.codim), lipschitz=A.lipschitz * B.lipschitz,
                         dtype=_dtype(A, B))
        self.A, self.B = A, B

    @property
    def device(self):
        return self.A.device or self.B.device

    def apply(self, x):
        X = x.reshape(self.A.dim, self.B.dim)
        return _cols(self.A, _rows(self.B, X))

    def adjoint(self, y):
        Y = torch.as_tensor(y).reshape(self.A.codim, self.B.codim)
        return _cols(self.A, _rows(self.B, Y, adjoint=True), adjoint=True)

    def pinv(self, y, **kwargs):
        """``(A kron B)^+ = A^+ kron B^+``: ``B``'s pinv on all rows at
        once, then ``A``'s on all columns (``pinv_batched``)."""
        Y = torch.as_tensor(y).reshape(self.A.codim, self.B.codim)
        X = self.B.pinv_batched(Y, **kwargs)
        return self.A.pinv_batched(X.T, **kwargs).T


class KroneckerSum(LinearOperator):
    """``A kronsum B = A kron I + I kron B`` for square factors;
    ``L = L_A + L_B``.  A factor given as an array becomes a DenseOperator
    on ``device``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator
        >>> from pycsou_tpu_torch.ops.kron import KroneckerSum
        >>> A = DiagonalOperator([1.0, 2.0])
        >>> B = DiagonalOperator([10.0, 20.0])
        >>> KroneckerSum(A, B)(torch.ones(4, device=dev)).reshape(-1).tolist()
        [11.0, 21.0, 12.0, 22.0]
    """

    def __init__(self, A, B, device=None):
        A, B = _as_op(A, device), _as_op(B, device)
        if A.dim != A.codim or B.dim != B.codim:
            raise ValueError("Kronecker sum requires square factors")
        dim = (A.dim, B.dim)
        super().__init__(dim, dim, lipschitz=A.lipschitz + B.lipschitz, dtype=_dtype(A, B))
        self.A, self.B = A, B

    @property
    def device(self):
        return self.A.device or self.B.device

    def apply(self, x):
        X = x.reshape(self.A.dim, self.B.dim)
        return _cols(self.A, X) + _rows(self.B, X)

    def adjoint(self, y):
        Y = torch.as_tensor(y).reshape(self.A.dim, self.B.dim)
        return _cols(self.A, Y, adjoint=True) + _rows(self.B, Y, adjoint=True)


class KhatriRaoProduct(LinearOperator):
    """Column-wise Kronecker product of two matrices sharing their column
    count: ``(A o B) x = vec(A diag(x) B^T)``.  ``lipschitz`` is the exact
    norm of the full matrix (the reference's numpy code) up to 4e6
    entries.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.kron import KhatriRaoProduct
        >>> A = torch.tensor([[1.0, 2.0]], device=dev)           # (1, 2)
        >>> B = torch.tensor([[1.0, 0.0], [0.0, 1.0]], device=dev)
        >>> KhatriRaoProduct(A, B)(torch.tensor([1.0, 1.0], device=dev)).reshape(-1).tolist()
        [1.0, 2.0]
    """

    def __init__(self, A, B, device=None):
        A = A.mat if isinstance(A, DenseOperator) else A
        B = B.mat if isinstance(B, DenseOperator) else B
        dev = resolve_device(device, A, B)
        A, B = as_tensor(A, dev, dtype_of(A)), as_tensor(B, dev, dtype_of(B))
        if A.shape[1] != B.shape[1]:
            raise ValueError("factors must share the column count")
        lip = float("inf")
        if A.shape[0] * B.shape[0] * A.shape[1] <= 4_000_000:
            a, b = A.cpu().numpy(), B.cpu().numpy()
            full = np.einsum("ij,kj->ikj", a, b).reshape(-1, a.shape[1])
            lip = float(np.linalg.norm(full, 2))
        super().__init__((A.shape[1],), (A.shape[0], B.shape[0]), lipschitz=lip,
                         dtype=torch.promote_types(A.dtype, B.dtype))
        self.A, self.B = A, B

    @property
    def device(self):
        return self.A.device

    def apply(self, x):
        # y[i, k] = sum_j A[i, j] B[k, j] x[j]
        with full_f32():
            return (self.A * x) @ self.B.T

    def adjoint(self, y):
        # x[j] = sum_ik conj(A[i, j]) conj(B[k, j]) y[i, k]
        with full_f32():
            return torch.sum(torch.conj(self.A) * (torch.as_tensor(y) @ torch.conj(self.B)), dim=0)
