"""Matrix-free linear operator algebra.

Counterpart of ``pycsou_tpu/core/linop.py``.  ``adjoint`` defaults to the
vector-Jacobian product of ``apply`` (``torch.func.vjp``, in place of
``jax.linear_transpose``; for a complex operator it is the Hermitian
adjoint); closed forms override it where a kernel is cheaper.  Spectral
quantities come from ``utils/opnorm.py`` (power iteration, Lanczos,
Arnoldi) and ``pinv`` from its conjugate gradients, each on the
operator's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.map import DifferentiableMap, Map

__all__ = [
    "LinearOperator",
    "SelfAdjointMixin",
    "UnitaryMixin",
    "AdjointOperator",
    "TransposeOperator",
    "LinOpSum",
    "LinOpComp",
    "SymmetricLinearOperator",
    "PinvOperator",
    "JacobianTOperator",
]

_INF = float("inf")
_TODENSE_CHUNK = 128  # basis vectors a chunk in todense (the reference's lax.map batch)


class LinearOperator(DifferentiableMap):
    """Abstract linear operator: implement ``apply``; ``adjoint`` is
    derived.  ``diff_lipschitz`` equals ``lipschitz`` (the reference's
    convention for linear maps).

    ``compute_lipschitz_cst()`` sets ``lipschitz`` from a power iteration
    on ``A^H A`` on the operator's device; ``PDS`` calls it when ``||K||``
    is unknown.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DenseOperator
        >>> A = DenseOperator([[2.0, 0.0], [1.0, 1.0]])
        >>> x, y = torch.tensor([1.0, 2.0], device=dev), torch.tensor([3.0, -1.0], device=dev)
        >>> bool(torch.isclose(torch.dot(A(x), y), torch.dot(x, A.adjoint(y))))
        True
        >>> bool(torch.allclose(A.gram(x), A.adjoint(A(x)), atol=1e-5))
        True
        >>> bool(torch.allclose(A.pinv(A(x)), x, atol=1e-3))   # CG normal equations
        True
    """

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF, dtype=torch.float32):
        DifferentiableMap.__init__(self, dim_shape, codim_shape, lipschitz=lipschitz, diff_lipschitz=lipschitz)
        self.dtype = dtype

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """``A^H y`` as the vector-Jacobian product of ``apply`` (exact for
        a linear map, at any linearisation point)."""
        y = torch.as_tensor(y)
        primal = torch.zeros(self.dim_shape, dtype=self.dtype, device=y.device)
        _, vjp = torch.func.vjp(self.apply, primal)
        (out,) = vjp(y)
        return out

    def matvec(self, x):
        """pylops-compatible alias for :meth:`apply`."""
        return self.apply(torch.as_tensor(x))

    def rmatvec(self, y):
        """pylops-compatible alias for :meth:`adjoint`."""
        return self.adjoint(y)

    def adjoint_batched(self, ys: torch.Tensor) -> torch.Tensor:
        """``adjoint`` over a leading batch axis."""
        return self._batched(self.adjoint, ys)

    @property
    def lipschitz(self) -> float:
        """Spectral-norm bound; setting it also sets ``diff_lipschitz``."""
        return self._lipschitz

    @lipschitz.setter
    def lipschitz(self, value: float):
        self._lipschitz = float(value)
        self._diff_lipschitz = float(value)

    def jacobianT(self, x=None):
        return self.H

    @property
    def H(self) -> "LinearOperator":
        """Hermitian adjoint operator."""
        return AdjointOperator(self)

    @property
    def T(self) -> "LinearOperator":
        """Transpose (the conjugate of the adjoint; the adjoint when real)."""
        if self.dtype.is_complex:
            return TransposeOperator(self)
        return AdjointOperator(self)

    def transpose(self):
        """Method form of :attr:`T`."""
        return self.T

    @property
    def gram(self) -> "LinearOperator":
        """``A^H A``."""
        return SymmetricLinearOperator(LinOpComp(self.H, self))

    @property
    def cogram(self) -> "LinearOperator":
        """``A A^H``."""
        return SymmetricLinearOperator(LinOpComp(self, self.H))

    # reference-compatible aliases
    DomainGram = gram
    RangeGram = cogram

    # -- spectral estimation ----------------------------------------------
    def opnorm(self, maxiter: int = 128, tol: float = 1e-6, key: int = 0) -> float:
        """Largest singular value by power iteration on ``A^H A``
        (``utils.opnorm.power_iteration``), read once on the host."""
        from pycsou_tpu_torch.utils.opnorm import power_iteration

        value = power_iteration(self, maxiter=maxiter, tol=tol, key=key)
        power_iteration.host_reads += 1
        return float(value)

    def compute_lipschitz_cst(self, tol: float = 1e-6, maxiter: int = 128, key: int = 0) -> float:
        """Estimate the spectral norm and keep it as ``lipschitz``."""
        value = self.opnorm(maxiter=maxiter, tol=tol, key=key)
        self.lipschitz = value
        return value

    def estimate_lipschitz(self, **kwargs) -> float:
        """Alias for :meth:`compute_lipschitz_cst`."""
        return self.compute_lipschitz_cst(**kwargs)

    def eigenvals(self, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, symmetric: bool = True):
        """Extremal eigenvalues: Lanczos for a self-adjoint operator (``'SM'``
        through :func:`~pycsou_tpu_torch.utils.opnorm.smallest_eig_psd`),
        Arnoldi otherwise."""
        if self.dim_shape != self.codim_shape:
            raise ValueError("eigenvals requires a square (endomorphic) operator")
        from pycsou_tpu_torch.utils import opnorm

        if symmetric:
            if which == "SM":
                lam = opnorm.smallest_eig_psd(self, maxiter=maxiter)
                return torch.tensor([lam], dtype=torch.float32)[:k]
            return opnorm.lanczos_eigs(self, k=k, which=which, maxiter=maxiter)
        return opnorm.arnoldi_eigs(self, k=k, which=which, maxiter=maxiter)

    def singularvals(self, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, method: str = "fold"):
        """Extremal singular values: square roots of the Gram's eigenvalues
        (``'SM'`` by the fold, or CG shift-invert with
        ``method='shift-invert'``)."""
        from pycsou_tpu_torch.utils import opnorm

        if which == "SM":
            lam = opnorm.smallest_eig_psd(self.gram, maxiter=maxiter, method=method)
            return torch.sqrt(torch.clamp(torch.tensor([lam], dtype=torch.float32), min=0.0))[:k]
        evals = opnorm.lanczos_eigs(self.gram, k=k, which=which, maxiter=maxiter)
        return torch.sqrt(torch.clamp(evals, min=0.0))

    def cond(self, maxiter: Optional[int] = None, method: str = "fold") -> float:
        """2-norm condition number ``sigma_max / sigma_min``."""
        sv = self.singularvals(k=1, which="LM", maxiter=maxiter)
        sv_min = self.singularvals(k=1, which="SM", maxiter=maxiter, method=method)
        return float(torch.max(sv) / torch.clamp(torch.min(sv_min), min=1e-30))

    # -- pseudo-inverse ----------------------------------------------------
    def pinv(self, y, damp: float = 0.0, tol: float = 1e-6, maxiter: int = 200):
        """Least-squares pseudo-inverse applied to ``y``: conjugate gradients
        on the (damped) normal equations (``utils.opnorm.cg``)."""
        from pycsou_tpu_torch.utils.opnorm import cg

        rhs = self.adjoint(torch.as_tensor(y))

        def mv(x):
            out = self.adjoint(self.apply(x))
            if damp:
                out = out + damp * x
            return out

        return cg(mv, rhs, tol=tol, maxiter=maxiter)

    def pinv_batched(self, ys, damp: float = 0.0, tol: float = 1e-6, maxiter: int = 200):
        """:meth:`pinv` of each row of ``ys`` (a leading batch axis), as the
        reference's ``jax.vmap`` of ``pinv``: one CG over the batch, with
        batched applies, each row stopping at its own test."""
        from pycsou_tpu_torch.utils.opnorm import cg

        ys = torch.as_tensor(ys)
        rhs = self.adjoint_batched(ys)

        def mv(xs):
            out = self.adjoint_batched(self.apply_batched(xs))
            if damp:
                out = out + damp * xs
            return out

        return cg(mv, rhs, tol=tol, maxiter=maxiter, batched=True)

    @property
    def PinvOp(self) -> "PinvOperator":
        """Matrix-free pseudo-inverse operator."""
        return PinvOperator(self)

    dagger = PinvOp

    @property
    def RowProjector(self) -> "LinearOperator":
        """Orthogonal projector onto the row space: ``A^dagger A``."""
        return SymmetricLinearOperator(LinOpComp(self.PinvOp, self))

    @property
    def ColProjector(self) -> "LinearOperator":
        """Orthogonal projector onto the column space: ``A A^dagger``."""
        return SymmetricLinearOperator(LinOpComp(self, self.PinvOp))

    # -- materialisation & interop ----------------------------------------
    def todense(self):
        """A :class:`~pycsou_tpu_torch.ops.basic.DenseOperator` of the
        matrix, on the operator's device: the standard basis mapped through
        :meth:`apply_batched`, 128 columns a batch."""
        from pycsou_tpu_torch.ops.basic import DenseOperator
        from pycsou_tpu_torch.utils.device import resolve_device

        dev = resolve_device(None, self.device)
        chunks = []
        for start in range(0, self.dim, _TODENSE_CHUNK):
            n = min(_TODENSE_CHUNK, self.dim - start)
            eye = torch.zeros(n, self.dim, dtype=self.dtype, device=dev)
            eye[:, start : start + n].fill_diagonal_(1)
            chunks.append(self.apply_batched(eye.reshape((n,) + self.dim_shape)).reshape(n, -1))
        mat = torch.cat(chunks).T  # (codim, dim)
        return DenseOperator(mat, dim_shape=self.dim_shape, codim_shape=self.codim_shape)

    def tosparse(self, threshold: float = 0.0):
        """A :class:`~pycsou_tpu_torch.ops.basic.SparseOperator` of the
        matrix, entries of magnitude at most ``threshold`` dropped when it
        is positive."""
        from pycsou_tpu_torch.ops.basic import SparseOperator

        mat = self.todense().mat
        if threshold > 0:
            mat = torch.where(torch.abs(mat) > threshold, mat, torch.zeros_like(mat))
        return SparseOperator(mat, dim_shape=self.dim_shape, codim_shape=self.codim_shape)

    def to_scipy_operator(self):
        """SciPy ``LinearOperator`` over ``apply``/``adjoint`` on the
        operator's device (numpy in, numpy out)."""
        import scipy.sparse.linalg as spla

        from pycsou_tpu_torch.utils.device import as_tensor, resolve_device

        dev = resolve_device(None, self.device)

        def mv(x):
            x = as_tensor(np.asarray(x).reshape(self.dim_shape), dev, self.dtype)
            return self.apply(x).reshape(-1).cpu().numpy()

        def rmv(y):
            y = as_tensor(np.asarray(y).reshape(self.codim_shape), dev, self.dtype)
            return self.adjoint(y).reshape(-1).cpu().numpy()

        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        return spla.LinearOperator(shape=self.shape, matvec=mv, rmatvec=rmv, dtype=np_dtype)


class SelfAdjointMixin:
    """Mixin for operators with ``A^H = A``."""

    def adjoint(self, y):
        return self.apply(torch.as_tensor(y))


class UnitaryMixin:
    """Mixin for unitary operators: ``L = 1``, Gram and co-Gram the
    identity, ``pinv`` the adjoint."""

    @property
    def gram(self):
        """``A^H A = I``."""
        from pycsou_tpu_torch.ops.basic import IdentityOperator

        return IdentityOperator(self.dim_shape, dtype=self.dtype)

    @property
    def cogram(self):
        """``A A^H = I``."""
        from pycsou_tpu_torch.ops.basic import IdentityOperator

        return IdentityOperator(self.codim_shape, dtype=self.dtype)

    def opnorm(self, **kwargs) -> float:
        """A unitary operator has spectral norm exactly 1."""
        return 1.0

    def pinv(self, y, **kwargs):
        """``A^+ = A^H`` (exact, no CG)."""
        return self.adjoint(y)

    def pinv_batched(self, ys, **kwargs):
        return self.adjoint_batched(ys)

    @property
    def PinvOp(self):
        """The adjoint operator (the exact pseudo-inverse)."""
        return AdjointOperator(self)


class AdjointOperator(LinearOperator):
    """``A^H`` as an operator."""

    def __init__(self, base: LinearOperator):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        return self.base.adjoint(x)

    def adjoint(self, y):
        return self.base.apply(y)

    @property
    def H(self):
        return self.base


class TransposeOperator(LinearOperator):
    """``A^T = conj(A^H)`` for complex operators."""

    def __init__(self, base: LinearOperator):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        return torch.conj_physical(self.base.adjoint(torch.conj(x)))

    def adjoint(self, y):
        return torch.conj_physical(self.base.apply(torch.conj(torch.as_tensor(y))))


class LinOpSum(LinearOperator):
    """``A + B``; the adjoint is the sum of adjoints."""

    def __init__(self, m1: LinearOperator, m2: LinearOperator):
        if m1.dim_shape != m2.dim_shape:
            raise ValueError(f"domain mismatch: {m1.dim_shape} vs {m2.dim_shape}")
        codim = m1.codim_shape if m1.codim_shape != () else m2.codim_shape
        if m1.codim_shape not in ((), codim) or m2.codim_shape not in ((), codim):
            raise ValueError(f"codomain mismatch: {m1.codim_shape} vs {m2.codim_shape}")
        dtype = torch.promote_types(m1.dtype, m2.dtype)
        super().__init__(m1.dim_shape, codim, lipschitz=m1.lipschitz + m2.lipschitz, dtype=dtype)
        self.m1, self.m2 = m1, m2

    @property
    def device(self):
        return self.m1.device or self.m2.device

    def apply(self, x):
        return self.m1.apply(x) + self.m2.apply(x)

    def adjoint(self, y):
        # a scalar-valued summand inside an array-valued sum acts through the
        # broadcast operator, whose adjoint sums y
        def term(m):
            if m.codim_shape == () and self.codim_shape != ():
                return m.adjoint(torch.sum(y))
            return m.adjoint(y)

        y = torch.as_tensor(y)
        return term(self.m1) + term(self.m2)


class LinOpComp(LinearOperator):
    """``A o B``; the adjoint is the reversed composition."""

    def __init__(self, m1: LinearOperator, m2: LinearOperator):
        if m2.codim_shape != m1.dim_shape:
            raise ValueError(
                f"cannot compose: inner codim {m2.codim_shape} != outer dim {m1.dim_shape}"
            )
        dtype = torch.promote_types(m1.dtype, m2.dtype)
        super().__init__(m2.dim_shape, m1.codim_shape, lipschitz=m1.lipschitz * m2.lipschitz, dtype=dtype)
        self.m1, self.m2 = m1, m2

    @property
    def device(self):
        return self.m1.device or self.m2.device

    def apply(self, x):
        return self.m1.apply(self.m2.apply(x))

    def adjoint(self, y):
        return self.m2.adjoint(self.m1.adjoint(y))


class SymmetricLinearOperator(LinearOperator):
    """Declares an operator self-adjoint."""

    def __init__(self, base: LinearOperator):
        if base.dim_shape != base.codim_shape:
            raise ValueError("symmetric operator must be square")
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    @property
    def device(self):
        return self.base.device

    def apply(self, x):
        return self.base.apply(x)

    def adjoint(self, y):
        return self.base.apply(torch.as_tensor(y))


class PinvOperator(LinearOperator):
    """Matrix-free Moore-Penrose pseudo-inverse: each apply is a CG solve
    of the damped normal equations."""

    batchable = False  # the CG reads its stopping flag on the host

    def __init__(self, base: LinearOperator, damp: float = 0.0, tol: float = 1e-6, maxiter: int = 200):
        super().__init__(base.codim_shape, base.dim_shape, dtype=base.dtype)
        self.base = base
        self.damp = float(damp)
        self.tol = float(tol)
        self.maxiter = int(maxiter)

    @property
    def device(self):
        return self.base.device

    def apply(self, y):
        return self.base.pinv(y, damp=self.damp, tol=self.tol, maxiter=self.maxiter)

    def adjoint(self, x):
        # (A^dagger)^H = (A^H)^dagger
        return self.base.H.pinv(x, damp=self.damp, tol=self.tol, maxiter=self.maxiter)


class JacobianTOperator(LinearOperator):
    """Transposed Jacobian of a differentiable map at a point, from autodiff:
    ``apply`` is the VJP, ``adjoint`` the JVP."""

    def __init__(self, base: Map, point: torch.Tensor):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=point.dtype)
        self.base = base
        self.point = point

    def apply(self, v):
        _, vjp = torch.func.vjp(self.base.apply, self.point)
        (out,) = vjp(v)
        return out

    def adjoint(self, u):
        _, out = torch.func.jvp(self.base.apply, (self.point,), (u,))
        return out
