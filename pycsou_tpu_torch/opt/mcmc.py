"""Proximal MCMC: the PMYULA (proximal Moreau-Yosida unadjusted Langevin)
sampler (counterpart of ``pycsou_tpu/opt/mcmc.py``).

The chain, the burn-in and thinning gates, the moment accumulators and the
P^2 quantile states all live in the state dict as device tensors, so a
sample never makes the host wait on the card.  The noise of sample ``n`` is
``kernels/langevin.py`` ``normal_noise(seed, n)``: a counter-based
generator, so the state carries no generator and nothing touches PyTorch's
global one.  The JAX package threads a PRNG key through its state instead;
the two packages draw different numbers from one seed.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver
from pycsou_tpu_torch.func.base import NullDifferentiableFunctional, NullProximableFunctional
from pycsou_tpu_torch.kernels.langevin import normal_noise, pmyula_mega_step
from pycsou_tpu_torch.opt.tv import rank1_gate
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape
from pycsou_tpu_torch.utils.stats import p2_add, p2_init, p2_quantile

__all__ = ["PMYULA"]

_INF = float("inf")


class PMYULA(IterativeSolver):
    r"""Sample from ``exp(-F(x) - G(x))`` by the Langevin update::

        x+ = (1 - gamma/tau) x - gamma grad F(x)
             + (gamma/tau) prox_{tau G}(x) + sqrt(2 gamma) xi

    (``x+ = x - gamma grad F(x) + sqrt(2 gamma) xi`` when G is absent).
    Automatic hyper-parameters: ``tau = 2/beta`` and ``gamma = tau/(beta tau
    + 1)``, or ``tau = 1`` and ``gamma = 1/beta`` when G is absent.  Samples
    ``n > max(burnin, 4)`` with ``(n - burnin) % thinning == 0`` are
    collected into the MMSE and second-moment sums, the P^2 quantiles of x
    and of each tracked linear operator's output, and the traces of
    ``scalar_fns`` (ESS and split-R-hat in :meth:`postprocess`).

    Engines: ``"megal"`` runs each sample as one K9 launch
    (``kernels/langevin.py``: both Gram directions, the prox blend, the
    noise drawn in the kernel and the accumulators).  It applies when no
    tracker is asked for (no ``linops``, ``pvalues`` or ``scalar_fns``),
    ``F = SquaredL2Loss(y) * Convolve2D(h)`` (or ``SquaredL2Loss(y)``) on 2-D
    images with a PSF that passes the rank-1 engines' gate
    (:func:`pycsou_tpu_torch.opt.tv.rank1_gate`, the reference's one source
    of these gates: rank 1, at most 16 taps per axis, ``H >= 3 m0``, ``W >=
    3 m1``), and G absent, the nonnegative orthant or ``lam * L1Norm``.
    ``""`` is the generic chain, with the same noise.

    ``use_pallas``: ``"auto"`` takes ``"megal"`` where it applies on a CUDA
    device and the generic chain otherwise; ``True`` (CUDA) and
    ``"interpret"`` (CPU: K9's plain version) ask for ``"megal"`` and raise
    where it does not apply; ``False`` takes the generic chain.

    Example: the posterior mean of ``exp(-||x - y||^2)`` is ``y``::

        >>> import torch
        >>> from pycsou_tpu_torch.func import SquaredL2Loss
        >>> from pycsou_tpu_torch.opt import PMYULA
        >>> y = torch.tensor([1.0, -1.0])
        >>> s = PMYULA((2,), F=SquaredL2Loss((2,), data=y), seed=0, nb_burnin_iterations=200)
        >>> out = s.postprocess(s.run_fixed(4000))
        >>> bool((out["mmse"] - y).abs().max() < 0.2)
        True
    """

    def __init__(
        self,
        dim_shape,
        F=None,
        G=None,
        tau: Optional[float] = None,
        gamma: Optional[float] = None,
        beta: Optional[float] = None,
        x0=None,
        linops: Optional[Sequence] = None,
        pvalues: Optional[Sequence[float]] = None,
        scalar_fns: Optional[Sequence] = None,
        nb_burnin_iterations: int = 0,
        thinning_factor: int = 1,
        seed: int = 0,
        max_iter: int = 10000,
        min_iter: int = 100,
        accuracy_threshold: float = 1e-4,
        verbose: Optional[int] = None,
        use_pallas="auto",
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        dim_shape = as_shape(dim_shape)
        dev = resolve_device(device, *[m.device for m in (F, G) if m is not None], x0)
        self.device = dev
        if F is None:
            self.F = NullDifferentiableFunctional(dim_shape)
            self.beta = float(beta) if beta is not None else 1.0
        else:
            self.F = F
            b = beta if beta is not None else getattr(F, "diff_lipschitz", _INF)
            if not math.isfinite(b):
                raise ValueError("F must have a Lipschitz gradient; pass beta=...")
            self.beta = float(b)
        self._G_null = G is None
        self.G = G if G is not None else NullProximableFunctional(dim_shape)

        if tau is not None and gamma is not None:
            self.tau, self.gamma = float(tau), float(gamma)
        elif tau is not None:
            self.tau = float(tau)
            self.gamma = float(tau) / (self.beta * float(tau) + 1)
        elif self._G_null:
            self.tau, self.gamma = 1.0, 1.0 / self.beta
        else:
            self.tau = 2.0 / self.beta
            self.gamma = self.tau / (self.beta * self.tau + 1)

        self.linops = tuple(linops) if linops is not None else ()
        self.pvalues = tuple(float(p) for p in pvalues) if pvalues is not None else ()
        self.scalar_fns = tuple(scalar_fns) if scalar_fns is not None else ()
        self.burnin = int(nb_burnin_iterations)
        self.thinning = int(thinning_factor)
        self.seed = int(seed)
        self.x0 = torch.zeros(dim_shape, device=dev) if x0 is None else as_tensor(x0, dev)

        if use_pallas not in ("auto", True, False, "interpret"):
            raise ValueError(f"use_pallas must be 'auto', True, False or 'interpret', not {use_pallas!r}")
        if use_pallas is True and dev.type != "cuda":
            raise ValueError(f"use_pallas=True launches K9 and needs a CUDA device; the device is {dev}")
        if use_pallas == "interpret" and dev.type != "cpu":
            raise ValueError(f"use_pallas='interpret' runs K9's plain version on CPU tensors; the device is {dev}")
        self.engine = ""
        if use_pallas in (True, "interpret") or (use_pallas == "auto" and dev.type == "cuda"):
            why = self._megal(dim_shape, F, G)
            if why is not None and use_pallas in (True, "interpret"):
                raise ValueError(f"use_pallas={use_pallas!r}: the fused engine does not apply: {why}")

    def _megal(self, dim_shape, F, G) -> Optional[str]:
        """Set up the fused engine and return None, or return why it does
        not apply (the reference's ``_try_fused_engine`` gates)."""
        from pycsou_tpu_torch.opt.fuse import _match_conv_least_squares, _why_G_l1, _why_G_nonneg
        from pycsou_tpu_torch.ops.conv import Convolve2D

        if self.linops or self.pvalues or self.scalar_fns:
            return "linops, pvalues and scalar_fns run on the generic chain"
        if len(dim_shape) != 2:
            return "the fused engine takes 2-D images"
        fy = _match_conv_least_squares(dim_shape, F) if F is not None else None
        if fy is None:
            return "F is not SquaredL2Loss(y) * Convolve2D(h) or SquaredL2Loss(y)"
        filt, y = fy
        prox_mode, lam = "none", 0.0
        if G is not None:
            nonneg, reason = _why_G_nonneg(G)
            if reason is None and nonneg:
                prox_mode = "nonneg"
            else:
                lam, reason = _why_G_l1(G, dim_shape)
                if reason is not None:
                    return f"G is not absent, the nonnegative orthant or lam * L1Norm ({reason})"
                prox_mode = "l1"
        A = Convolve2D(dim_shape, np.ones((1, 1), np.float32) if filt is None else filt.filt, device=self.device)
        why = rank1_gate(A.gram)
        if why is not None:
            return f"the PSF is outside the rank-1 engines' gate: {why}"
        self._lg_fwd, self._lg_adj2 = A.fwd, A.fwd.adjoint(2.0)
        self._lg_atb = A.adjoint(as_tensor(y, self.device))
        self._prox_mode, self._lam_l1 = prox_mode, float(lam)
        wrapped = (self.seed + 2**31) % 2**32 - 2**31  # the seed's 32-bit word as an int32
        self._seed_i32 = torch.tensor(wrapped, dtype=torch.int32, device=self.device)
        self.engine = "megal"
        return None

    def _sharded_twin(self) -> "PMYULA":
        """The copy ``with_shardings`` steps: the generic chain in place of
        the fused engine (K9), as the reference's ``_without_pallas``
        (``pycsou_tpu/opt/mcmc.py``) drops its fused Langevin kernel.  The
        chain draws the same noise (``normal_noise(seed, n)``), so its
        samples are the fused engine's up to float32 rounding."""
        if not self.engine:
            return self
        return self.replace(engine="", _lg_fwd=None, _lg_adj2=None, _lg_atb=None)

    def with_shardings(self, **shardings) -> "PMYULA":
        """The generic sharded copy (``IterativeSolver.with_shardings``) of
        :meth:`_sharded_twin`."""
        return IterativeSolver.with_shardings(self._sharded_twin(), **shardings)

    # -- state ---------------------------------------------------------------
    def initial_state(self):
        dev = self.device
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        state = {
            "x": self.x0,
            "n": torch.zeros((), dtype=torch.int32, device=dev),  # the sampler's own counter
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mmse_raw": zeros(self.x0.shape),
            "m2_raw": zeros(self.x0.shape),
            "p2_raw": [p2_init(p, self.x0.shape, device=dev) for p in self.pvalues],
            "mmse_ops": [zeros(op.codim_shape) for op in self.linops],
            "m2_ops": [zeros(op.codim_shape) for op in self.linops],
            "p2_ops": [[p2_init(p, op.codim_shape, device=dev) for p in self.pvalues] for op in self.linops],
        }
        if self.scalar_fns:
            # per-sample traces, room for every possible sample
            state["traces"] = zeros((len(self.scalar_fns), self.max_iter))
        return state

    def _collect(self, it):
        """Whether the sample made at iteration ``it`` is collected."""
        return (it > max(self.burnin, 4)) & ((it - self.burnin) % self.thinning == 0)

    def step(self, state):
        x, it = state["x"], state["n"]
        collect = self._collect(it)
        w = collect.to(torch.float32)
        out = {"n": it + 1, "count": state["count"] + collect.to(torch.int32)}
        if self.engine:
            si = torch.stack([self._seed_i32, it])
            out["x"], out["mmse_raw"], out["m2_raw"] = pmyula_mega_step(
                x, self._lg_atb, state["mmse_raw"], state["m2_raw"], si, w.reshape(1),
                self._lg_fwd, self._lg_adj2, gamma=self.gamma, tau=self.tau, lam=self._lam_l1,
                prox_mode=self._prox_mode,
            )
            # no trackers on this engine: their (empty) entries pass through
            out.update({k: state[k] for k in ("p2_raw", "mmse_ops", "m2_ops", "p2_ops")})
            return out

        g = self.gamma
        xi = normal_noise(self.seed, it, x.shape, x.device)
        ns = float(np.sqrt(np.float32(2.0 * g)))  # in float32, as the reference
        if self._G_null:
            x_new = x - g * self.F.gradient(x) + ns * xi
        else:
            x_new = ((1 - g / self.tau) * x - g * self.F.gradient(x)
                     + (g / self.tau) * self.G.prox(x, self.tau) + ns * xi)
        out["x"] = x_new
        out["mmse_raw"] = state["mmse_raw"] + w * x_new
        out["m2_raw"] = state["m2_raw"] + w * x_new**2

        def gated(s, sample):
            new = p2_add(s, sample)
            return {k: torch.where(collect, new[k], s[k]) for k in s}

        out["p2_raw"] = [gated(s, x_new) for s in state["p2_raw"]]
        for key in ("mmse_ops", "m2_ops", "p2_ops"):
            out[key] = []
        for i, op in enumerate(self.linops):
            y = op.apply(x_new)
            out["mmse_ops"].append(state["mmse_ops"][i] + w * y)
            out["m2_ops"].append(state["m2_ops"][i] + w * y**2)
            out["p2_ops"].append([gated(s, y) for s in state["p2_ops"][i]])
        if self.scalar_fns:
            vals = torch.stack([torch.as_tensor(f(x_new), dtype=torch.float32, device=x.device).reshape(())
                                for f in self.scalar_fns])
            traces = state["traces"]
            idx = state["count"].to(torch.int64).clamp(max=traces.shape[1] - 1).reshape(1)
            cur = traces.index_select(1, idx)[:, 0]
            out["traces"] = traces.index_copy(1, idx, torch.where(collect, vals, cur)[:, None])
        return out

    def objective(self, x):
        """The negative log-posterior ``F(x) + G(x)``."""
        return self.F.apply(x) + self.G.apply(x)

    def metric(self, old, new):
        """Relative change of the running MMSE estimate; between collected
        samples the estimate does not move, and the metric holds its last
        value rather than reading as a spurious 0."""
        m_old = old["mmse_raw"] / torch.clamp(old["count"].to(torch.float32), min=1.0)
        m_new = new["mmse_raw"] / torch.clamp(new["count"].to(torch.float32), min=1.0)
        n_old = torch.sqrt(torch.sum(m_old**2))
        n_diff = torch.sqrt(torch.sum((m_new - m_old) ** 2))
        rel = torch.where(n_old == 0, _INF, n_diff / torch.where(n_old == 0, 1.0, n_old))
        return torch.where(new["count"] > old["count"], rel, old["metric"])

    def postprocess(self, state):
        """MMSE, pointwise standard deviation, quantiles, the tracked
        operators' moments and the traces' ESS and split-R-hat."""
        cnt = torch.clamp(state["count"].to(torch.float32), min=1.0)

        def moments(m, m2):
            return m / cnt, torch.sqrt(torch.clamp(m2 / cnt - (m / cnt) ** 2, min=0.0))

        mmse, std = moments(state["mmse_raw"], state["m2_raw"])
        out = {"x": state["x"], "mmse": mmse, "std": std, "n_samples": state["count"]}
        if self.pvalues:
            out["quantiles"] = {p: p2_quantile(s) for p, s in zip(self.pvalues, state["p2_raw"])}
        if self.linops:
            pairs = [moments(m, m2) for m, m2 in zip(state["mmse_ops"], state["m2_ops"])]
            out["mmse_linops"] = [m for m, _ in pairs]
            out["std_linops"] = [s for _, s in pairs]
            if self.pvalues:
                out["quantiles_linops"] = [
                    {p: p2_quantile(s) for p, s in zip(self.pvalues, states)} for states in state["p2_ops"]
                ]
        if self.scalar_fns:
            from pycsou_tpu_torch.utils.diagnostics import effective_sample_size, split_rhat

            n = int(state["count"])
            traces = state["traces"][:, :n]
            out["traces"] = traces
            if n >= 8:
                out["ess"] = torch.stack([effective_sample_size(t) for t in traces])
                out["rhat"] = torch.stack([split_rhat(t) for t in traces])
        return out
