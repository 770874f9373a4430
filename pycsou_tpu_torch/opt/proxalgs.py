"""Condat-Vu primal-dual splitting (counterpart of
``pycsou_tpu/opt/proxalgs.py`` ``PrimalDualSplitting``/``PDS`` and its
Chambolle-Pock special case ``CPS``).

Same update rule, automatic step sizes and momentum as the reference.
``fuse=True`` pattern-matches the (F, G, H, K) expression (``opt/fuse.py``:
TV deconvolution, inpainting and super-resolution, then Chambolle-Pock TV
denoising) and delegates the iteration to the fused TV engine;
``fuse=False`` steps the expression generically and is the oracle the
fused path is held against.  A fusion that raises is not caught: the
error reaches the caller.  APGD, DRS and FBS wait for ROADMAP Queue 1
item 7.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.func.base import NullDifferentiableFunctional, NullProximableFunctional
from pycsou_tpu_torch.ops.basic import IdentityOperator, NullOperator
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["PrimalDualSplitting", "PDS", "ChambollePockSplitting", "CPS"]

_INF = float("inf")


def _ensure_opnorm(K: LinearOperator) -> float:
    if not math.isfinite(K.lipschitz):
        K.compute_lipschitz_cst()  # raises until utils/opnorm.py is ported
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
        metric_every: int = 1,
        fuse: bool = True,
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold,
                         verbose=verbose, metric_every=metric_every)
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
            state = self._fused.initial_state()
            state["x"] = self.x0.clone()
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
        """The generic contract is (x, z); the fused engine's split duals are
        recombined in :meth:`metrics`."""
        if self._fused is not None:
            return ("x", "z")
        return super().diagnostics_vars(state)

    def metrics(self, old, new):
        if self._fused is None:
            if "_gstats" in new:
                st = new["_gstats"]
                return {"x": _rel_from_sums(st[0], st[1]), "z": _rel_from_sums(st[2], st[3])}
            return super().metrics(old, new)
        st = new["_stats"]
        return {"x": _rel_from_sums(st[0], st[1]), "z": _rel_from_sums(st[2] + st[4], st[3] + st[5])}

    def postprocess(self, state):
        """The generic contract (``x`` and a stacked ``z``) also when the
        fused engine carried split duals."""
        out = super().postprocess(state)
        if self._fused is not None and "z0" in out:
            out["z"] = torch.stack([out.pop("z0"), out.pop("z1")], dim=0)
        return out


PDS = PrimalDualSplitting


class ChambollePockSplitting(PrimalDualSplitting):
    """PDS with F = None and rho = 1 (``pycsou_tpu/opt/proxalgs.py``
    ``ChambollePockSplitting``)."""

    def __init__(self, dim_shape, G=None, H=None, K=None, tau=None, sigma=None, rho=1.0, x0=None,
                 z0=None, **kwargs):
        super().__init__(dim_shape, F=None, G=G, H=H, K=K, tau=tau, sigma=sigma, rho=rho, x0=x0,
                         z0=z0, **kwargs)


CPS = ChambollePockSplitting
