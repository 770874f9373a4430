"""Spectral estimation on the device: power iteration, Lanczos, Arnoldi,
the smallest eigenvalue of a PSD operator, and conjugate gradients.

Counterpart of ``pycsou_tpu/utils/opnorm.py``.  The reference runs each
loop inside ``lax.while_loop``/``fori_loop``.  Here the host drives a Python
loop that only enqueues work:

* :func:`power_iteration` and :func:`cg` keep their state and a ``done``
  flag on the device.  From the iteration whose stopping test passed on,
  the state is frozen (``torch.where``), and the host reads ``done`` once
  every ``_SYNC_EVERY`` (16, ``solve()``'s) iterations.  The result is the
  reference's: the state of the iteration at which the reference stops,
  after at most ``maxiter`` operator applies that count.  Up to 15 applies
  run past that iteration and change nothing; with ``_SYNC_EVERY = 1`` (as
  the tests set it) ``done`` is read before every apply and the applies
  are exactly the reference's.
* Lanczos and Arnoldi run a fixed number of steps and read the host once,
  for the small (m x m) eigenproblem, which is solved there in float64
  numpy as in the reference.

The random start vector comes from :func:`_rand_like`: a CPU
``torch.Generator`` seeded with ``key``, then moved to the operator's
device, so one ``key`` gives one start on the CPU and on the card.  It is
not JAX's ``PRNGKey(key)`` draw (ROADMAP Queue 3).

Each of :func:`power_iteration` and :func:`cg` counts, in its attributes
``applies`` and ``host_reads``, the operator applies it launched and the
times it read ``done`` (and, for the power iteration, its result) on the
host, as the kernel wrappers count their launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch._module import Module
from pycsou_tpu_torch.core.solver import _SYNC_EVERY  # read at call time: the tests set it here
from pycsou_tpu_torch.utils.device import full_f32, resolve_device

__all__ = ["power_iteration", "lanczos_eigs", "arnoldi_eigs", "smallest_eig_psd", "cg"]


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype if dtype.is_complex else dtype


def _vdot_real(x, y) -> torch.Tensor:
    """``Re <x, y>`` over every element (a 0-d tensor)."""
    return torch.real(torch.vdot(x.reshape(-1), y.reshape(-1)))


def _norm(x) -> torch.Tensor:
    return torch.sqrt(_vdot_real(x, x))


def _op_device(op) -> torch.device:
    return resolve_device(None, op.device)


def _rand_like(key: int, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normal start vector (real and imaginary parts each standard
    normal for a complex dtype) from a CPU generator seeded with ``key``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(key))
    if dtype.is_complex:
        re = torch.randn(shape, generator=g, dtype=torch.float32)
        im = torch.randn(shape, generator=g, dtype=torch.float32)
        v = torch.complex(re, im).to(dtype)
    else:
        v = torch.randn(shape, generator=g, dtype=dtype)
    return v.to(device)


def _power_iter(op, x0, maxiter: int, tol: float):
    """sigma_max by power iteration on ``A^H A``: ``(sqrt(s), n)`` as 0-d
    device tensors, ``n`` the Gram applies that counted (the reference's)."""
    tiny = torch.finfo(_real_dtype(x0.dtype)).tiny

    def gram(v):
        power_iteration.applies += 1
        return op.adjoint(op.apply(v))

    x0 = x0 / torch.clamp(_norm(x0), min=tiny)
    y = gram(x0)
    s = _norm(y)
    x = y / torch.clamp(s, min=tiny)
    ds = torch.full_like(s, float("inf"))
    n = torch.ones((), dtype=torch.int32, device=s.device)
    done = torch.zeros((), dtype=torch.bool, device=s.device)
    it = 1  # applies so far
    while it < maxiter:
        for _ in range(min(_SYNC_EVERY, maxiter - it)):
            y = gram(x)
            s_new = _norm(y)
            run = ~done
            x = torch.where(run, y / torch.clamp(s_new, min=tiny), x)
            ds = torch.where(run, torch.abs(s_new - s), ds)
            s = torch.where(run, s_new, s)
            n = n + run.to(torch.int32)
            # the reference's loop condition, negated
            done = ~(ds > tol * torch.clamp(s, min=1e-30))
            it += 1
        power_iteration.host_reads += 1
        if bool(done):
            break
    return torch.sqrt(s), n


def power_iteration(op, maxiter: int = 128, tol: float = 1e-6, key: int = 0) -> torch.Tensor:
    """Estimate ``||A||_2`` (the largest singular value) of a linear
    operator, as a 0-d tensor on its device: power iteration on ``A^H A``
    from the start vector of ``key``, stopping once the Gram's norm moves by
    at most ``tol`` relative, after at most ``maxiter`` Gram applies.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator
        >>> from pycsou_tpu_torch.utils.opnorm import power_iteration
        >>> est = power_iteration(DiagonalOperator([1.0, -3.0, 2.0]))
        >>> round(float(est), 3)
        3.0
    """
    x0 = _rand_like(key, op.dim_shape, op.dtype, _op_device(op))
    value, _ = _power_iter(op, x0, int(maxiter), float(tol))
    return value


power_iteration.applies = 0
power_iteration.host_reads = 0


def cg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *, tol: float = 1e-5, atol: float = 0.0,
       maxiter: Optional[int] = None, batched: bool = False) -> torch.Tensor:
    """Conjugate gradients for ``A x = b`` with ``A`` a Hermitian positive
    definite matvec: ``jax.scipy.sparse.linalg.cg``'s iteration and its
    rule, stop once ``||r||^2 <= max(tol^2 ||b||^2, atol^2)`` or after
    ``maxiter`` iterations (default ``10 * b.numel()``).  One apply of
    ``A`` goes to ``r0 = b - A x0``, as there.

    With ``batched``, each row of ``b`` (its leading axis) is a system of
    its own, as under ``jax.vmap`` of that ``cg``: ``A`` maps the whole
    batch, every inner product and stopping test is a row's, a row's state
    freezes once its test passes, and the loop ends when every row's has."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if batched:
        if maxiter is None:
            maxiter = 10 * b[0].numel()
        axes = tuple(range(1, b.ndim))

        def dot(x, y):
            return torch.real(torch.sum(torch.conj(x) * y, dim=axes))

        def col(t):  # a row's scalar against the row
            return t.reshape(t.shape + (1,) * len(axes))
    else:
        if maxiter is None:
            maxiter = 10 * b.numel()
        dot = _vdot_real

        def col(t):
            return t

    def mv(v):
        cg.applies += 1
        return A(v)

    atol2 = torch.clamp(tol**2 * dot(b, b), min=atol**2)
    x = x0
    r = b - mv(x0)
    p = r
    gamma = dot(r, r)
    done = ~(gamma > atol2)
    it = 0
    while it < maxiter:
        cg.host_reads += 1
        if bool(done.all()):
            break
        for _ in range(min(_SYNC_EVERY, maxiter - it)):
            ap = mv(p)
            alpha = col(gamma / dot(p, ap))
            x_new = x + alpha * p
            r_new = r - alpha * ap
            gamma_new = dot(r_new, r_new)
            p_new = r_new + col(gamma_new / gamma) * p
            run = ~done
            x = torch.where(col(run), x_new, x)
            r = torch.where(col(run), r_new, r)
            p = torch.where(col(run), p_new, p)
            gamma = torch.where(run, gamma_new, gamma)
            done = ~(gamma > atol2)
            it += 1
    return x


cg.applies = 0
cg.host_reads = 0


def _lanczos(op, v0: torch.Tensor, m: int):
    """m-step Lanczos with full reorthogonalisation for a self-adjoint
    operator: ``(alphas, betas)`` of the tridiagonal, float32 on the
    device.  The basis ``V`` is an ``(m,) + dim_shape`` tensor there."""
    shape, dtype = tuple(v0.shape), v0.dtype
    tiny = torch.finfo(_real_dtype(dtype)).tiny
    V = torch.zeros((m,) + shape, dtype=dtype, device=v0.device)
    V[0] = v0 / torch.clamp(_norm(v0), min=tiny)
    alphas = torch.zeros(m, dtype=torch.float32, device=v0.device)
    betas = torch.zeros(m, dtype=torch.float32, device=v0.device)
    for j in range(m):
        vj = V[j]
        w = op.apply(vj)
        alpha = _vdot_real(vj, w)
        w = w - alpha.to(dtype) * vj
        # against every earlier vector (those after j are still zero)
        basis = V[: j + 1].reshape(j + 1, -1)
        with full_f32():
            coeffs = torch.conj(basis) @ w.reshape(-1)
            w = w - (coeffs @ basis).reshape(shape)
        beta = _norm(w)
        if j + 1 < m:
            V[j + 1] = w / torch.clamp(beta, min=tiny)
        alphas[j] = alpha.to(torch.float32)
        betas[j] = beta.to(torch.float32)
    return alphas, betas


def _arnoldi(op, v0: torch.Tensor, m: int) -> torch.Tensor:
    """m-step Arnoldi for an endomorphic (generally non-symmetric)
    operator, classical Gram-Schmidt applied twice: the ``(m + 1, m)``
    upper-Hessenberg matrix, on the device."""
    shape, dtype = tuple(v0.shape), v0.dtype
    V = torch.zeros((m + 1,) + shape, dtype=dtype, device=v0.device)
    V[0] = v0 / torch.clamp(_norm(v0), min=torch.finfo(_real_dtype(dtype)).tiny)
    Hm = torch.zeros((m + 1, m), dtype=dtype, device=v0.device)
    tiny32 = torch.finfo(torch.float32).tiny
    for j in range(m):
        w = op.apply(V[j])
        basis = V[: j + 1].reshape(j + 1, -1)
        with full_f32():
            c1 = torch.conj(basis) @ w.reshape(-1)
            w = w - (c1 @ basis).reshape(shape)
            c2 = torch.conj(basis) @ w.reshape(-1)
            w = w - (c2 @ basis).reshape(shape)
        beta = _norm(w)
        V[j + 1] = w / torch.clamp(beta, min=tiny32)
        Hm[: j + 1, j] = c1 + c2
        Hm[j + 1, j] = beta.to(dtype)
    return Hm


def _order(evals: np.ndarray, which: str, kinds) -> np.ndarray:
    keys = {
        "LM": lambda e: -np.abs(e), "SM": np.abs,
        "LA": lambda e: -e, "SA": lambda e: e,
        "LR": lambda e: -e.real, "SR": lambda e: e.real,
    }
    if which not in kinds:
        raise ValueError(f"unknown which={which!r}")
    return np.argsort(keys[which](evals))


def lanczos_eigs(op, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, key: int = 0):
    """Extremal eigenvalues of a self-adjoint operator: Lanczos on the
    device, then the eigenvalues of the small tridiagonal on the host.  A
    float32 CPU tensor of ``k`` values."""
    m = int(min(op.dim, maxiter if maxiter is not None else max(2 * k + 10, 32)))
    v0 = _rand_like(key, op.dim_shape, op.dtype, _op_device(op))
    alphas, betas = _lanczos(op, v0, m)
    alphas = alphas.cpu().numpy().astype(np.float64)
    betas = betas.cpu().numpy().astype(np.float64)
    T = np.diag(alphas) + np.diag(betas[: m - 1], 1) + np.diag(betas[: m - 1], -1)
    evals = np.linalg.eigvalsh(T)
    order = _order(evals, which, ("LM", "SM", "LA", "SA"))
    return torch.from_numpy(evals[order[:k]].astype(np.float32))


def arnoldi_eigs(op, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, key: int = 0):
    """Extremal eigenvalues of an endomorphic operator: Arnoldi on the
    device, then the eigenvalues of the small Hessenberg matrix on the host.
    A complex64 CPU tensor of ``k`` values (exact, up to f32, when ``m``
    reaches the dimension)."""
    m = int(min(op.dim, maxiter if maxiter is not None else max(3 * k + 16, 32)))
    v0 = _rand_like(key, op.dim_shape, op.dtype, _op_device(op))
    Hm = _arnoldi(op, v0, m).cpu().numpy()
    Hm = Hm.astype(np.complex128 if np.iscomplexobj(Hm) else np.float64)
    evals = np.linalg.eigvals(Hm[:m, :m])
    order = _order(evals, which, ("LM", "SM", "LR", "SR"))
    return torch.from_numpy(evals[order[:k]].astype(np.complex64))


class _SpectralWrapOp(Module):
    """Self-adjoint wrapper base for :func:`smallest_eig_psd`."""

    def __init__(self, base, c=0.0, damp=0.0, tol=1e-8, maxiter=500):
        self.base = base
        self.c = float(c)
        self.damp = float(damp)
        self.tol = float(tol)
        self.maxiter = int(maxiter)

    @property
    def dim_shape(self):
        return self.base.dim_shape

    @property
    def codim_shape(self):
        return self.base.codim_shape

    @property
    def dim(self):
        return self.base.dim

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def adjoint(self, v):
        return self.apply(v)


class _FoldedOp(_SpectralWrapOp):
    """``v -> c v - A v`` for a self-adjoint PSD ``A``: its largest
    eigenvalue is ``c - lambda_min(A)`` (the spectrum fold)."""

    def apply(self, v):
        return self.c * v - self.base.apply(v)


class _CGInverseOp(_SpectralWrapOp):
    """``v -> (A + damp I)^{-1} v`` by :func:`cg`: its largest eigenvalue
    is ``1 / (lambda_min(A) + damp)``."""

    def apply(self, v):
        def mv(w):
            out = self.base.apply(w)
            if self.damp:
                out = out + self.damp * w
            return out

        return cg(mv, v, tol=self.tol, maxiter=self.maxiter)


def smallest_eig_psd(op, maxiter: Optional[int] = None, key: int = 0, method: str = "fold",
                     cg_tol: float = 1e-8, cg_maxiter: int = 500) -> float:
    """Smallest eigenvalue of a self-adjoint PSD operator.

    * ``method='fold'``: ``lambda_min = c - lambda_max(c I - A)`` with ``c``
      just above ``lambda_max(A)``; two Lanczos runs.  The subtraction
      cancels in f32: the relative accuracy degrades like
      ``eps_f32 * lambda_max / lambda_min``.
    * ``method='shift-invert'``: Lanczos on the CG-inverted operator, one CG
      solve an apply.
    """
    if method == "fold":
        lam_max = float(np.real(lanczos_eigs(op, 1, "LA", maxiter=maxiter, key=key)[0]))
        c = lam_max * (1.0 + 1e-3) + 1e-12
        lam = float(np.real(lanczos_eigs(_FoldedOp(op, c), 1, "LA", maxiter=maxiter, key=key + 1)[0]))
        return max(c - lam, 0.0)
    if method == "shift-invert":
        inv = _CGInverseOp(op, tol=cg_tol, maxiter=cg_maxiter)
        mu = float(np.real(lanczos_eigs(inv, 1, "LA", maxiter=maxiter, key=key)[0]))
        return 1.0 / mu if mu > 0 else 0.0
    raise ValueError("method must be 'fold' or 'shift-invert'")
