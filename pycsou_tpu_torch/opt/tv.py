"""TV-regularised 2-D deconvolution with fused Condat-Vu iterations
(counterpart of ``pycsou_tpu/opt/tv.py`` ``TVDeconvolution``, conv mode).

Engines (``stencil=``):

* ``"megar"`` — kernel K4 alone: the Gram gradient and the stencil in one
  pass (7 image streams).  ``"auto"`` picks it on a CUDA device, for any
  PSF of rank <= 4 (rank 1 included).
* ``"sweep"`` — the K2 gradient, then the K3 stencil (10 image streams).
* ``"plain"`` — K4's plain PyTorch version, for CPU tensors only;
  ``"auto"`` picks it on the CPU.

All three emit the six metric partial sums, so the stopping metric costs
no extra pass.  The reference's other engines (mega3, mega2, mega, element,
sweepm, sweepm2, megarm), its mask mode and its large-denoise reroute are
not ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.kernels.conv2d import sepgram2d
from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_step_stats
from pycsou_tpu_torch.kernels.tvr import tv_pds_megar_step, tv_pds_megar_step_plain
from pycsou_tpu_torch.ops.conv import Convolve2D
from pycsou_tpu_torch.ops.diff import fdiff_forward
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["TVDeconvolution"]

ENGINES = ("auto", "megar", "sweep", "plain")
# the reference's engines this port does not have yet -> where they wait
# (ROADMAP Queue 2, "still to port")
UNPORTED_ENGINES = {
    "mega3": "ROADMAP Queue 2 item 1 (two-step temporal blocking on K4)",
    "mega2": "ROADMAP Queue 2 item 2",
    "mega": "ROADMAP Queue 2 item 3",
    "element": "ROADMAP Queue 2 item 4 (tv_pds_stencil_step)",
    "sweepm": "ROADMAP Queue 2 item 5 (mask mode)",
    "sweepm2": "ROADMAP Queue 2 item 6 (mask mode)",
    "megarm": "ROADMAP Queue 2 item 7 (megar with mask=)",
}
_CUDA_ENGINES = ("megar", "sweep")
_LARGE_DENOISE = 1 << 21  # pixels; the reference reroutes denoising past it


class TVDeconvolution(IterativeSolver):
    """``min_x ||A x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})`` by
    Condat-Vu PDS, ``A`` a 2-D 'same' convolution (the identity when
    ``filt`` is None).  ``isotropic=False`` takes the anisotropic
    ``lam ||grad x||_1``.  The device is ``device`` if given, else that of
    ``y``."""

    def __init__(
        self,
        shape,
        y,
        lam: float,
        filt=None,
        nonneg: bool = True,
        tau: Optional[float] = None,
        sigma: Optional[float] = None,
        rho: float = 0.9,
        stencil: str = "auto",
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        metric_every: int = 1,
        isotropic: bool = True,
        mask=None,
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold,
                         verbose=verbose, metric_every=metric_every)
        shape = as_shape(shape)
        if stencil in UNPORTED_ENGINES:
            raise NotImplementedError(
                f"stencil={stencil!r} is not ported yet: {UNPORTED_ENGINES[stencil]}"
            )
        if stencil not in ENGINES:
            raise ValueError(f"unknown stencil {stencil!r}; expected one of {ENGINES}")
        if mask is not None:
            raise NotImplementedError(
                "TVDeconvolution mask mode is not ported yet (ROADMAP Queue 1 item 10)"
            )
        if filt is None and shape[0] * shape[1] >= _LARGE_DENOISE:
            raise NotImplementedError(
                "denoising at >= 2**21 pixels runs on the masked engines in the "
                "reference, which are not ported yet (ROADMAP Queue 1 item 10)"
            )
        dev = resolve_device(device, y, filt)
        if stencil == "auto":
            stencil = "megar" if dev.type == "cuda" else "plain"
        elif stencil in _CUDA_ENGINES and dev.type != "cuda":
            raise ValueError(f"stencil={stencil!r} launches CUDA kernels; the solver's device is {dev}")
        elif stencil == "plain" and dev.type != "cpu":
            raise ValueError(f"stencil='plain' runs on CPU tensors only; the solver's device is {dev}")
        if filt is None:
            # denoising as the identity 1x1 convolution: gram = I, atb = y
            filt = np.ones((1, 1), np.float32)
        conv = Convolve2D(shape, filt, device=dev)
        if conv.method != "band":
            raise NotImplementedError(
                "TVDeconvolution needs a PSF of rank <= 4 within 31 taps per axis; the "
                "FFT Gram for other PSFs is not ported yet (ROADMAP Queue 1 item 5)"
            )
        self.device = dev
        self.y = as_tensor(y, dev)
        if tuple(self.y.shape) != shape:
            raise ValueError(f"y has shape {tuple(self.y.shape)}, expected {shape}")
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.iso = bool(isotropic)
        self.rho = float(rho)
        self.gram = conv.gram
        self.atb = conv.adjoint(self.y)
        self.beta = 2.0 * conv.lipschitz**2
        L_K = math.sqrt(8.0)
        if tau is None:
            b = self.beta
            tau = (1.0 / L_K**2) * (-b / 4 + math.sqrt(b**2 / 16 + L_K**2))
        self.tau = float(tau)
        self.sigma = float(tau) if sigma is None else float(sigma)
        self.stencil_mode = stencil

    # -- iteration ---------------------------------------------------------
    def initial_state(self):
        z = lambda: torch.zeros(self.y.shape, dtype=torch.float32, device=self.device)  # noqa: E731
        return {"x": z(), "z0": z(), "z1": z(), "_stats": torch.zeros(6, device=self.device)}

    def step(self, state):
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        kw = dict(tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam,
                  nonneg=self.nonneg, iso=self.iso)
        g = self.gram
        if self.stencil_mode == "megar":
            x, z0, z1, stats = tv_pds_megar_step(x, z0, z1, self.atb, g.fwd, g.adj2, **kw)
        elif self.stencil_mode == "sweep":
            grad = sepgram2d(x, g.fwd, g.adj2, self.atb)
            x, z0, z1, stats = tv_pds_sweep_step_stats(x, z0, z1, grad, **kw)
        else:
            x, z0, z1, stats = tv_pds_megar_step_plain(x, z0, z1, self.atb, g.fwd, g.adj2, **kw)
        return {"x": x, "z0": z0, "z1": z1, "_stats": stats}

    # -- metrics from the engines' partial sums ----------------------------
    def metric(self, old, new):
        st = new["_stats"]
        return _rel_from_sums(st[0], st[1])

    def metrics(self, old, new):
        st = new["_stats"]
        return {
            "x": _rel_from_sums(st[0], st[1]),
            "z0": _rel_from_sums(st[2], st[3]),
            "z1": _rel_from_sums(st[4], st[5]),
        }

    def objective(self, x):
        """``||A x - y||^2 + lam TV(x)``, the data term through the Gram
        identity ``<x, A^H A x> - 2 <x, A^H y> + ||y||^2``."""
        x = torch.as_tensor(x)
        data = torch.sum(x * self.gram.apply(x)) - 2.0 * torch.sum(x * self.atb) + torch.sum(self.y * self.y)
        dx, dy = fdiff_forward(x, 0), fdiff_forward(x, 1)
        tv = torch.sum(torch.sqrt(dx**2 + dy**2)) if self.iso else torch.sum(dx.abs()) + torch.sum(dy.abs())
        return data + self.lam * tv
