"""Plain Condat-Vu primal-dual splitting for isotropic TV problems

    min_x  ||A x - y||^2 + lam ||grad x||_{2,1}  (+ i_{x >= 0}),

written from the published method (Condat 2013, Vu 2013; upstream Pycsou's
``PDS``) in plain PyTorch, with none of the program's code, weights or
tables.  ``grad`` is the forward difference along each axis with its last
entry 0; its adjoint is the negative divergence.  The step sizes are the
closed-form rule for beta > 0 with ``||grad|| <= sqrt(8)``:

    tau = sigma = (1 / 8) (-beta / 4 + sqrt(beta^2 / 16 + 8)),  rho given.

One iteration from (x, z):

    x' = proj(x - tau (grad F(x) + grad^T z))
    z' = proj_{||.|| <= lam}(z + sigma grad(2 x' - x))       (per pixel)
    x <- rho x' + (1 - rho) x;   z <- rho z' + (1 - rho) z

and the stopping metric of the iteration is ``||x_new - x|| / ||x||``.

Every tensor of the iteration is held in ``dtype``: float64 for the
reference, a lower precision for the control.  An operator's FFTs, which
have no half-precision form, run in float32 for the lower precisions and
are rounded back."""
from __future__ import annotations

import math

import torch


def fft_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def steps(beta: float):
    """``(tau, sigma)`` of the closed-form rule for ``||K|| = sqrt(8)``."""
    lk2 = 8.0
    tau = (1.0 / lk2) * (-beta / 4.0 + math.sqrt(beta * beta / 16.0 + lk2))
    return tau, tau


def _add_d(out, u, axis, alpha):
    """``out += alpha * D u``: the forward difference along ``axis``, whose
    last entry is 0."""
    n = u.shape[axis]
    out.narrow(axis, 0, n - 1).add_(u.narrow(axis, 1, n - 1) - u.narrow(axis, 0, n - 1), alpha=alpha)


def _add_dt(out, z, axis):
    """``out += D^T z`` with ``(D^T z)_j = z_{j-1} - z_j``, ``z_{-1} = z_{n-1}
    = 0``."""
    n = z.shape[axis]
    out.narrow(axis, 0, n - 1).sub_(z.narrow(axis, 0, n - 1))
    out.narrow(axis, 1, n - 1).add_(z.narrow(axis, 0, n - 1))


def _sumsq(a) -> float:
    a = a.to(torch.float64) if a.dtype != torch.float64 else a
    return float(torch.sum(a * a))


class Run:
    """The outcome of :func:`solve`: ``x`` after ``n_compare`` iterations,
    ``x_end`` after the last of the ``n_run`` run, and ``crossed``, the
    first iteration at or after ``min_iter`` whose metric is at most ``tol``
    (None when none within the iterations run)."""

    def __init__(self, x, x_end, crossed, n_run):
        self.x, self.x_end, self.crossed, self.n_run = x, x_end, crossed, n_run


def solve(problem, lam: float, rho: float, nonneg: bool, n_compare: int, n_run: int,
          tol: float, min_iter: int, dtype=torch.float64, stop_at_crossing: bool = False) -> Run:
    """``n_run`` iterations (at least ``n_compare``) of the method from
    ``x = z = 0``.  ``problem`` gives ``shape``, ``device``, ``beta`` (the
    Lipschitz constant of grad F) and ``grad(x, dtype)`` (= 2 A^H (A x - y)).
    ``stop_at_crossing``: end at the first crossing past ``n_compare``
    iterations (as a solver would), else run all ``n_run``."""
    tau, sigma = steps(problem.beta)
    dev, shape = problem.device, problem.shape
    x = torch.zeros(shape, dtype=dtype, device=dev)
    z0 = torch.zeros_like(x)
    z1 = torch.zeros_like(x)
    x_at = None
    crossed = None
    k = 0
    for k in range(1, max(n_run, n_compare) + 1):
        g = problem.grad(x, dtype)  # grad F(x), then + K^T z in place
        _add_dt(g, z0, 0)
        _add_dt(g, z1, 1)
        xt = torch.add(x, g, alpha=-tau)
        if nonneg:
            xt.clamp_min_(0)
        dx = xt - x
        u = xt + dx  # 2 x' - x
        v0, v1 = z0.clone(), z1.clone()
        _add_d(v0, u, 0, sigma)
        _add_d(v1, u, 1, sigma)
        # the projection onto the lam-ball of each pixel's (v0, v1)
        scale = torch.clamp(lam / torch.sqrt(v0 * v0 + v1 * v1), max=1.0)
        x_new = torch.add(x, dx, alpha=rho)  # rho x' + (1 - rho) x
        z0 = z0.mul_(1 - rho).add_(v0.mul_(scale), alpha=rho)
        z1 = z1.mul_(1 - rho).add_(v1.mul_(scale), alpha=rho)
        d2, o2 = rho * rho * _sumsq(dx), _sumsq(x)
        rel = math.sqrt(d2) / math.sqrt(o2) if o2 > 0 else (0.0 if d2 == 0 else math.inf)
        x = x_new
        if crossed is None and k >= min_iter and rel <= tol:
            crossed = k
        if k == n_compare:
            x_at = x
        if stop_at_crossing and crossed is not None and k >= n_compare:
            break
    return Run(x_at if x_at is not None else x, x, crossed, k)
