"""Proximal splitting solvers (counterpart of ``pycsou_tpu/opt/proxalgs.py``):
the Condat-Vu primal-dual splitting ``PDS`` and its special cases ``CPS``
(Chambolle-Pock), ``DRS`` (Douglas-Rachford) and ``FBS`` (forward-backward),
and ``APGD`` (FISTA).

Same update rules, automatic step sizes and momentum as the reference.
``fuse=True`` pattern-matches the expression (``opt/fuse.py``): a PDS onto
the fused TV engine (TV deconvolution, inpainting and super-resolution,
Chambolle-Pock TV denoising), an APGD, or an FBS at ``rho = 1``, onto the
fused LASSO engine; ``fuse=False`` steps the expression generically and is
the oracle the fused path is held against.  A fusion that raises is not
caught: the error reaches the caller.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.func.base import NullDifferentiableFunctional, NullProximableFunctional
from pycsou_tpu_torch.ops.basic import IdentityOperator, NullOperator
from pycsou_tpu_torch.opt.lasso import ACCELERATIONS, momentum
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = [
    "PrimalDualSplitting",
    "PDS",
    "AcceleratedProximalGradientDescent",
    "APGD",
    "ChambollePockSplitting",
    "CPS",
    "DouglasRachfordSplitting",
    "DRS",
    "ForwardBackwardSplitting",
    "FBS",
]

_INF = float("inf")


def _ensure_opnorm(K: LinearOperator) -> float:
    if not math.isfinite(K.lipschitz):
        K.compute_lipschitz_cst()  # power iteration on K^H K (utils/opnorm.py)
    return K.lipschitz


def _sumsq(a) -> torch.Tensor:
    return torch.sum(a * a)


class PrimalDualSplitting(IterativeSolver):
    r"""Condat-Vu three-term splitting for ``min F(x) + G(x) + H(Kx)``::

        x+ = prox_{tau G}(x - tau grad F(x) - tau K^H z)
        u  = 2 x+ - x
        z+ = prox_{sigma H*}(z + sigma K u)
        x  = rho x+ + (1 - rho) x;  z likewise

    Auto step sizes: for beta > 0,
    ``tau = sigma = (1/||K||^2)(-beta/4 + sqrt(beta^2/16 + ||K||^2))``;
    for beta = 0, ``tau = sigma = 1/||K||``.  rho = 0.9 (beta > 0) else 1.

    The device is ``device`` if given, else that of the first of F, G, H,
    K, x0 that holds tensors, else PyTorch's default device."""

    def __init__(
        self,
        dim_shape,
        F=None,
        G=None,
        H=None,
        K=None,
        tau: Optional[float] = None,
        sigma: Optional[float] = None,
        rho: Optional[float] = None,
        beta: Optional[float] = None,
        x0=None,
        z0=None,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-3,
        verbose: Optional[int] = None,
        remat: bool = False,
        metric_every: int = 1,
        fuse: bool = True,
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold,
                         verbose=verbose, remat=remat, metric_every=metric_every)
        dim_shape = as_shape(dim_shape)
        held = [m.device for m in (F, G, H, K) if m is not None]
        dev = resolve_device(device, *held, x0)
        self.device = dev

        if F is None:
            self.F = NullDifferentiableFunctional(dim_shape)
            self.beta = 0.0
        else:
            if F.dim_shape != dim_shape:
                raise ValueError(f"F domain {F.dim_shape} != {dim_shape}")
            self.F = F
            b = beta if beta is not None else getattr(F, "diff_lipschitz", _INF)
            if not math.isfinite(b):
                raise ValueError("F must have a (known) Lipschitz-continuous gradient; pass beta=...")
            self.beta = float(b)

        if G is None:
            self.G = NullProximableFunctional(dim_shape)
        else:
            if G.dim_shape != dim_shape:
                raise ValueError(f"G domain {G.dim_shape} != {dim_shape}")
            self.G = G

        if H is not None:
            self.H = H
            self._has_H = True
            if K is None:
                self.K = IdentityOperator(H.dim_shape)
            else:
                if K.dim_shape != dim_shape or K.codim_shape != H.dim_shape:
                    raise ValueError(
                        f"K maps {K.dim_shape}->{K.codim_shape}, inconsistent with H domain {H.dim_shape}"
                    )
                self.K = K
        else:
            self.H = NullProximableFunctional(dim_shape)
            self._has_H = False
            self.K = NullOperator(dim_shape, dim_shape)

        if tau is not None and sigma is not None:
            self.tau, self.sigma = float(tau), float(sigma)
        elif tau is not None:
            self.tau = self.sigma = float(tau)
        elif sigma is not None:
            self.tau = self.sigma = float(sigma)
        else:
            self.tau, self.sigma = self.set_step_sizes()
        self.rho = float(rho) if rho is not None else self.set_momentum_term()

        self.x0 = torch.zeros(dim_shape, device=dev) if x0 is None else as_tensor(x0, dev)
        if self._has_H:
            self.z0 = torch.zeros(self.H.dim_shape, device=dev) if z0 is None else as_tensor(z0, dev)
        else:
            self.z0 = torch.zeros((1,), device=dev)

        # metric partial sums computed inside step() (metric_every=1)
        self._instats = int(metric_every) == 1
        self._fused = None
        if fuse and self._has_H:
            from pycsou_tpu_torch.opt import fuse

            for match in (fuse.match_tv_deconvolution, fuse.match_cps_tv_denoise):
                self._fused = match(
                    dim_shape, self.F, self.G, self.H, self.K, self.tau, self.sigma, self.rho,
                    metric_every=metric_every, device=dev,
                )
                if self._fused is not None:
                    break
            if self._fused is not None:
                self.iters_per_step = self._fused.iters_per_step
            else:
                note = fuse.explain_tv_mismatch(dim_shape, self.F, self.G, self.H, self.K)
                if note:
                    fuse.logger.warning(note)
        elif fuse and F is not None and G is not None:
            # FBS: with H absent this is proximal gradient, which at rho = 1
            # is FISTA with zero momentum (the LASSO engine with
            # acceleration=None); rho != 1 blends with the previous x, which
            # the engine's (x_temp - x_temp_old) momentum cannot express
            from pycsou_tpu_torch.opt import fuse

            fused = fuse.match_lasso(dim_shape, self.F, self.G, self.tau, None, 75.0,
                                     metric_every=metric_every, device=dev)
            if fused is not None and self.rho != 1.0:
                fuse.logger.warning(
                    "FBS expression matches the fused FISTA engine but its rho="
                    f"{self.rho} relaxation keeps it on the generic chain; pass rho=1 to fuse"
                )
                fused = None
            self._fused = fused

    # -- auto-tuning -------------------------------------------------------
    def set_step_sizes(self):
        """(tau, sigma) from the reference's closed-form rules."""
        if self.beta > 0:
            if not self._has_H:
                return 2.0 / self.beta, 0.0
            L = _ensure_opnorm(self.K)
            tau = (1.0 / L**2) * (-self.beta / 4 + math.sqrt(self.beta**2 / 16 + L**2))
            return tau, tau
        if not self._has_H:
            return 1.0, 0.0
        L = _ensure_opnorm(self.K)
        return 1.0 / L, 1.0 / L

    def set_momentum_term(self):
        return 0.9 if self.beta > 0 else 1.0

    # -- iteration ---------------------------------------------------------
    def initial_state(self):
        if self._fused is not None:
            # the fused engine's layout: split duals (TV), or no dual at all
            # (the LASSO engine an FBS routes to)
            state = self._fused.initial_state()
            state["x"] = self.x0.clone()
            if "z0" in state:
                state["z0"] = self.z0[0].clone()
                state["z1"] = self.z0[1].clone()
            return state
        state = {"x": self.x0, "z": self.z0}
        if self._instats:
            state["_gstats"] = torch.zeros(4, device=self.device)
        return state

    def step(self, state):
        if self._fused is not None:
            return self._fused.step(state)
        x_old, z_old = state["x"], state["z"]
        tau, sigma, rho = self.tau, self.sigma, self.rho
        grad = self.F.gradient(x_old)
        if self._has_H:
            x_temp = self.G.prox(x_old - tau * grad - tau * self.K.adjoint(z_old), tau)
            u = 2 * x_temp - x_old
            z_temp = self.H.fenchel_prox(z_old + sigma * self.K.apply(u), sigma)
            z = rho * z_temp + (1 - rho) * z_old
        else:
            x_temp = self.G.prox(x_old - tau * grad, tau)
            z = z_old
        x = rho * x_temp + (1 - rho) * x_old
        out = {"x": x, "z": z}
        if self._instats:
            # sums over the momentum pass's inputs: dx = rho (x_temp - x_old)
            rho2 = rho * rho
            dz2 = rho2 * _sumsq(z_temp - z_old) if self._has_H else torch.zeros((), device=x.device)
            out["_gstats"] = torch.stack(
                [rho2 * _sumsq(x_temp - x_old), _sumsq(x_old), dz2, _sumsq(z_old)]
            )
        return out

    def _wrap_state(self, state):
        if self._instats and self._fused is None and "_gstats" not in state:
            state = dict(state)
            state["_gstats"] = torch.zeros(4, device=self.device)
        return super()._wrap_state(state)

    def metric(self, old, new):
        if self._fused is not None:
            return self._fused.metric(old, new)
        if "_gstats" in new:
            return _rel_from_sums(new["_gstats"][0], new["_gstats"][1])
        return super().metric(old, new)

    def diagnostics_vars(self, state):
        """The generic contract is (x, z); the fused TV engine's split duals
        are recombined in :meth:`metrics`.  The LASSO engine an FBS routes
        to has no dual: its own contract applies."""
        if self._fused is not None:
            return ("x", "z") if "z0" in state else self._fused.diagnostics_vars(state)
        return super().diagnostics_vars(state)

    def metrics(self, old, new):
        if self._fused is None:
            if "_gstats" in new:
                st = new["_gstats"]
                return {"x": _rel_from_sums(st[0], st[1]), "z": _rel_from_sums(st[2], st[3])}
            return super().metrics(old, new)
        if "z0" not in new:
            return self._fused.metrics(old, new)
        st = new["_stats"]
        return {"x": _rel_from_sums(st[0], st[1]), "z": _rel_from_sums(st[2] + st[4], st[3] + st[5])}

    def objective(self, x):
        """The primal objective ``F(x) + G(x) + H(K x)``, also when a fused
        engine steps the solve."""
        val = self.F.apply(x) + self.G.apply(x)
        if self._has_H:
            val = val + self.H.apply(self.K.apply(x))
        return val

    def postprocess(self, state):
        """The generic contract (``x`` and a stacked ``z``) also when the
        fused engine carried split duals."""
        out = super().postprocess(state)
        if self._fused is not None and "z0" in out:
            out["z"] = torch.stack([out.pop("z0"), out.pop("z1")], dim=0)
        return out


PDS = PrimalDualSplitting


class AcceleratedProximalGradientDescent(IterativeSolver):
    r"""APGD / FISTA for ``min F(x) + G(x)``::

        x_temp = prox_{tau G}(x - tau grad F(x))
        t+ = (1 + sqrt(1 + 4 t^2)) / 2          ('BT')
           = (n + d) / d                        ('CD', d = 75)
           = 1                                  (None: no momentum)
        x  = x_temp + ((t - 1) / t+) (x_temp - x_temp_old)

    with the automatic ``tau = 1/beta``.  ``n`` is the solver's own
    iteration counter in the state, a device tensor like ``t``, so the
    momentum never makes the host wait.  The stopping metric watches
    ``x_temp``.

    ``fuse=True`` matches the LASSO pattern (``F = SquaredL2Loss(y) *
    Convolve2D``, ``G = lam * L1Norm``) and delegates the iteration to
    :class:`~pycsou_tpu_torch.opt.lasso.LassoDeconvolution`; an expression
    one slot away logs why it was not fused.  The device is ``device`` if
    given, else that of the first of F, G, x0 that holds tensors, else
    PyTorch's default device."""

    def __init__(
        self,
        dim_shape,
        F=None,
        G=None,
        tau: Optional[float] = None,
        acceleration: Optional[str] = "CD",
        beta: Optional[float] = None,
        x0=None,
        d: float = 75.0,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-3,
        verbose: Optional[int] = None,
        remat: bool = False,
        metric_every: int = 1,
        fuse: bool = True,
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold,
                         verbose=verbose, remat=remat, metric_every=metric_every)
        dim_shape = as_shape(dim_shape)
        dev = resolve_device(device, *[m.device for m in (F, G) if m is not None], x0)
        self.device = dev
        if F is None:
            self.F = NullDifferentiableFunctional(dim_shape)
            self.beta = 0.0
        else:
            self.F = F
            b = beta if beta is not None else getattr(F, "diff_lipschitz", _INF)
            if not math.isfinite(b):
                raise ValueError("F must have a (known) Lipschitz-continuous gradient; pass beta=...")
            self.beta = float(b)
        self.G = G if G is not None else NullProximableFunctional(dim_shape)
        if acceleration not in ACCELERATIONS:
            raise ValueError("acceleration must be 'BT', 'CD' or None")
        self.acceleration = acceleration
        self.d = float(d)
        if tau is not None:
            self.tau = float(tau)
        elif self.beta == 0:
            raise ValueError("cannot auto-tune tau with beta = 0; pass tau=...")
        else:
            self.tau = 1.0 / self.beta
        self.x0 = torch.zeros(dim_shape, device=dev) if x0 is None else as_tensor(x0, dev)
        self.primary_var = "x_temp"
        self._instats = int(metric_every) == 1

        self._fused = None
        if fuse and F is not None and G is not None:
            from pycsou_tpu_torch.opt import fuse

            self._fused = fuse.match_lasso(dim_shape, self.F, self.G, self.tau, self.acceleration,
                                           self.d, metric_every=metric_every, device=dev)
            if self._fused is None:
                note = fuse.explain_lasso_mismatch(dim_shape, self.F, self.G)
                if note:
                    fuse.logger.warning(note)

    def initial_state(self):
        state = {
            "x": self.x0,
            "x_temp": torch.zeros_like(self.x0),
            "t": torch.ones((), dtype=torch.float32, device=self.device),
            "n": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        if self._fused is not None:
            # the same keys, with the engine's metric partial sums
            fstate = self._fused.initial_state()
            fstate.update(state)
            return fstate
        if self._instats:
            state["_gstats"] = torch.zeros(4, device=self.device)
        return state

    def step(self, state):
        if self._fused is not None:
            return self._fused.step(state)
        x, x_old, n = state["x"], state["x_temp"], state["n"]
        x_temp = self.G.prox(x - self.tau * self.F.gradient(x), self.tau)
        a, t = momentum(self.acceleration, self.d, state["t"], n)
        dxt = x_temp - x_old
        x_new = x_temp + a * dxt
        out = {"x": x_new, "x_temp": x_temp, "t": t, "n": n + 1}
        if self._instats:
            # x_temp's improvement (the stopping metric), then the
            # extrapolated point's
            out["_gstats"] = torch.stack(
                [_sumsq(dxt), _sumsq(x_old), _sumsq(x_new - x), _sumsq(x)]
            )
        return out

    def _wrap_state(self, state):
        if self._instats and self._fused is None and "_gstats" not in state:
            state = dict(state)
            state["_gstats"] = torch.zeros(4, device=self.device)
        return super()._wrap_state(state)

    def metric(self, old, new):
        if self._fused is not None:
            return self._fused.metric(old, new)
        if "_gstats" in new:
            return _rel_from_sums(new["_gstats"][0], new["_gstats"][1])
        return super().metric(old, new)

    def metrics(self, old, new):
        if self._fused is not None:
            return self._fused.metrics(old, new)
        if "_gstats" in new:
            st = new["_gstats"]
            return {"x": _rel_from_sums(st[2], st[3]), "x_temp": _rel_from_sums(st[0], st[1])}
        return super().metrics(old, new)

    def objective(self, x):
        """``F(x) + G(x)``."""
        return self.F.apply(x) + self.G.apply(x)


APGD = AcceleratedProximalGradientDescent


class ChambollePockSplitting(PrimalDualSplitting):
    """PDS with F = None and rho = 1 (``pycsou_tpu/opt/proxalgs.py``
    ``ChambollePockSplitting``)."""

    def __init__(self, dim_shape, G=None, H=None, K=None, tau=None, sigma=None, rho=1.0, x0=None,
                 z0=None, **kwargs):
        super().__init__(dim_shape, F=None, G=G, H=H, K=K, tau=tau, sigma=sigma, rho=rho, x0=x0,
                         z0=z0, **kwargs)


CPS = ChambollePockSplitting


class DouglasRachfordSplitting(PrimalDualSplitting):
    """PDS with F = None, K = Id, sigma = 1/tau and rho = 1
    (``pycsou_tpu/opt/proxalgs.py`` ``DouglasRachfordSplitting``)."""

    def __init__(self, dim_shape, G=None, H=None, tau: float = 1.0, x0=None, z0=None, **kwargs):
        super().__init__(dim_shape, F=None, G=G, H=H, K=None, tau=tau, sigma=1.0 / tau, rho=1.0,
                         x0=x0, z0=z0, **kwargs)


DRS = DouglasRachfordSplitting


class ForwardBackwardSplitting(PrimalDualSplitting):
    """PDS with H = None and K = None: proximal gradient (ISTA), fused onto
    the LASSO engine at ``rho = 1`` (``pycsou_tpu/opt/proxalgs.py``
    ``ForwardBackwardSplitting``)."""

    def __init__(self, dim_shape, F=None, G=None, tau=None, rho=None, beta=None, x0=None, **kwargs):
        super().__init__(dim_shape, F=F, G=G, H=None, K=None, tau=tau, rho=rho, beta=beta, x0=x0,
                         **kwargs)


FBS = ForwardBackwardSplitting
