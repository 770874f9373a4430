"""TV-regularised 2-D deconvolution, inpainting and super-resolution with
fused Condat-Vu iterations (counterpart of ``pycsou_tpu/opt/tv.py``
``TVDeconvolution``).

Three modes, as in the reference:

* **conv** (``filt`` given or None, no ``mask``): ``A`` a 'same'
  convolution, the identity when ``filt`` is None (denoising).
* **mask** (``mask`` given, no ``filt``): ``A`` a sampling operator whose
  Gram is the diagonal ``mask`` (the per-pixel sample count ``A^H 1``);
  ``y`` is the back-projection ``A^H y_obs``.  Denoising at >= 2**21 pixels
  runs here too, with an all-ones mask, as in the reference.
* **combined** (``filt`` and ``mask``): ``A = M o C``, blurred and sampled
  data; the Gram is ``C^H diag(mask) C`` and ``y`` is ``M^H y_obs``.

Engines (``stencil=``), each emitting the six metric partial sums, so the
stopping metric costs no extra pass:

* conv: ``"megar"`` (K4 alone, 7 image streams; the CUDA ``"auto"``) and
  ``"sweep"`` (the K2 gradient, then the K3 stencil; 10 streams);
* mask: ``"sweepm2"`` (K6, two iterations per launch, ``iters_per_step =
  2``; the CUDA ``"auto"``) and ``"sweepm"`` (K5, one iteration);
* combined: ``"megarm"`` (K7; the CUDA ``"auto"``);
* every mode: ``"plain"``, the kernels' plain PyTorch versions one
  iteration a step, for CPU tensors only (``"auto"`` on the CPU).

The reference's rank-1 engines (mega3, mega2, mega) and its element-halo
engine are not ported yet and raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.kernels.conv2d import sepgram2d
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_sweep_step_stats,
    tv_pds_sweepm2_step,
    tv_pds_sweepm_step_stats,
    tv_pds_sweepm_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tvr import (
    tv_pds_megar_step,
    tv_pds_megar_step_plain,
    tv_pds_megarm_step_plain,
)
from pycsou_tpu_torch.ops.conv import Convolve2D
from pycsou_tpu_torch.ops.diff import fdiff_forward
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["TVDeconvolution"]

# each mode's CUDA engines, the "auto" choice first
MODE_ENGINES = {"conv": ("megar", "sweep"), "mask": ("sweepm2", "sweepm"), "combined": ("megarm",)}
_CUDA_ENGINES = sum(MODE_ENGINES.values(), ())
ENGINES = ("auto",) + _CUDA_ENGINES + ("plain",)
# the reference's engines this port does not have yet -> where they wait
# (ROADMAP Queue 2, "still to port")
UNPORTED_ENGINES = {
    "mega3": "ROADMAP Queue 2 item 1 (two-step temporal blocking on K4)",
    "mega2": "ROADMAP Queue 2 item 2",
    "mega": "ROADMAP Queue 2 item 3",
    "element": "ROADMAP Queue 2 item 4 (tv_pds_stencil_step)",
}
_LARGE_DENOISE = 1 << 21  # pixels; the reference reroutes denoising past it


class TVDeconvolution(IterativeSolver):
    """``min_x ||A x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})`` by
    Condat-Vu PDS, ``A`` a 2-D 'same' convolution (the identity when
    ``filt`` is None), a sampling operator of diagonal Gram ``mask``, or
    both (see the module docstring).  ``isotropic=False`` takes the
    anisotropic ``lam ||grad x||_1``.  The device is ``device`` if given,
    else that of ``y``."""

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
        dev = resolve_device(device, y, filt, mask)
        self.device = dev
        self.y = as_tensor(y, dev)
        if tuple(self.y.shape) != shape:
            raise ValueError(f"y has shape {tuple(self.y.shape)}, expected {shape}")
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.iso = bool(isotropic)
        self.rho = float(rho)

        self.filt = None  # the PSF (a 1x1 marker on the large-denoise reroute)
        self.mask = None
        self.conv = None  # combined mode's convolution
        self.gram = None  # conv mode's Gram
        if mask is None and filt is None and (
            stencil in MODE_ENGINES["mask"]
            or (stencil in ("auto", "plain") and shape[0] * shape[1] >= _LARGE_DENOISE)
        ):
            # large denoising (A = I) is the all-ones diagonal Gram: it runs
            # on the masked engines, as in the reference; the same problem
            # (atb = y, beta = 2, the same auto steps)
            mask = torch.ones(shape, dtype=torch.float32, device=dev)
            self.filt = torch.ones((1, 1), dtype=torch.float32, device=dev)
        if mask is not None:
            m = as_tensor(mask, dev)
            if tuple(m.shape) != shape:
                raise ValueError(f"mask shape {tuple(m.shape)} != image shape {shape}")
            self.mask = m
            m_max = float(torch.max(m))
        if mask is not None and filt is not None:
            mode = "combined"
            conv = self._band_conv(shape, filt, dev)
            self.conv = conv
            self.filt = conv.filt
            self._adj2 = conv.fwd.adjoint(2.0)
            self.atb = conv.adjoint(self.y)
            self.beta = 2.0 * m_max * conv.lipschitz**2
        elif mask is not None:
            mode = "mask"
            self.atb = self.y
            self.beta = 2.0 * m_max
        else:
            mode = "conv"
            if filt is None:
                # denoising as the identity 1x1 convolution: gram = I, atb = y
                filt = np.ones((1, 1), np.float32)
            conv = self._band_conv(shape, filt, dev)
            self.filt = conv.filt
            self.gram = conv.gram
            self.atb = conv.adjoint(self.y)
            self.beta = 2.0 * conv.lipschitz**2
        self.mode = mode

        if stencil == "auto":
            stencil = MODE_ENGINES[mode][0] if dev.type == "cuda" else "plain"
        elif stencil != "plain" and stencil not in MODE_ENGINES[mode]:
            raise ValueError(
                f"{mode} mode supports stencil 'auto', "
                + ", ".join(repr(e) for e in MODE_ENGINES[mode]) + f" or 'plain', not {stencil!r}"
            )
        elif stencil in _CUDA_ENGINES and dev.type != "cuda":
            raise ValueError(f"stencil={stencil!r} launches CUDA kernels; the solver's device is {dev}")
        elif stencil == "plain" and dev.type != "cpu":
            raise ValueError(f"stencil='plain' runs on CPU tensors only; the solver's device is {dev}")
        self.stencil_mode = stencil
        if stencil == "sweepm2":
            self.iters_per_step = 2

        L_K = math.sqrt(8.0)
        if tau is None:
            b = self.beta
            tau = (1.0 / L_K**2) * (-b / 4 + math.sqrt(b**2 / 16 + L_K**2))
        self.tau = float(tau)
        self.sigma = float(tau) if sigma is None else float(sigma)

    @staticmethod
    def _band_conv(shape, filt, dev) -> Convolve2D:
        conv = Convolve2D(shape, filt, device=dev)
        if conv.method != "band":
            raise NotImplementedError(
                "TVDeconvolution needs a PSF of rank <= 4 within 31 taps per axis; the "
                "FFT Gram for other PSFs is not ported yet (ROADMAP Queue 1 item 5)"
            )
        return conv

    # -- iteration ---------------------------------------------------------
    def initial_state(self):
        z = lambda: torch.zeros(self.y.shape, dtype=torch.float32, device=self.device)  # noqa: E731
        return {"x": z(), "z0": z(), "z1": z(), "_stats": torch.zeros(6, device=self.device)}

    def step(self, state):
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        kw = dict(tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam,
                  nonneg=self.nonneg, iso=self.iso)
        engine, m, atb = self.stencil_mode, self.mask, self.atb
        if self.mode == "conv":
            g = self.gram
            if engine == "megar":
                out = tv_pds_megar_step(x, z0, z1, atb, g.fwd, g.adj2, **kw)
            elif engine == "sweep":
                out = tv_pds_sweep_step_stats(x, z0, z1, sepgram2d(x, g.fwd, g.adj2, atb), **kw)
            else:
                out = tv_pds_megar_step_plain(x, z0, z1, atb, g.fwd, g.adj2, **kw)
        elif self.mode == "mask":
            if engine == "sweepm2":
                out = tv_pds_sweepm2_step(x, z0, z1, m, atb, **kw)
            elif engine == "sweepm":
                out = tv_pds_sweepm_step_stats(x, z0, z1, m, atb, **kw)
            else:
                out = tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw)
        else:
            fwd, adj2 = self.conv.fwd, self._adj2
            if engine == "megarm":
                out = tv_pds_megar_step(x, z0, z1, atb, fwd, adj2, mask=m, **kw)
            else:
                out = tv_pds_megarm_step_plain(x, z0, z1, m, atb, fwd, adj2, **kw)
        x, z0, z1, stats = out
        return {"x": x, "z0": z0, "z1": z1, "_stats": stats}

    # -- metrics from the engines' partial sums ----------------------------
    def metric(self, old, new):
        """From the engine's partial sums; for sweepm2 they measure the
        second iteration of the step only (the reference's convention)."""
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
        """``||A x - y||^2 + lam TV(x)``.  Conv mode evaluates the data term
        through the Gram identity ``<x, A^H A x> - 2 <x, A^H y> + ||y||^2``;
        mask and combined modes score the observed pixels only,
        ``sum m (t - y / max(m, 1))^2`` with ``t = x`` or ``C x`` (exact for
        0/1 masks; for sample counts > 1 correct up to the constant spread
        of repeated observations, as in the reference)."""
        x = torch.as_tensor(x)
        if self.mode == "combined":
            yc = self.y / torch.clamp(self.mask, min=1.0)
            data = torch.sum(self.mask * (self.conv.apply(x) - yc) ** 2)
        elif self.mode == "mask":
            yc = self.atb / torch.clamp(self.mask, min=1.0)
            data = torch.sum(self.mask * (x - yc) ** 2)
        else:
            data = (torch.sum(x * self.gram.apply(x)) - 2.0 * torch.sum(x * self.atb)
                    + torch.sum(self.y * self.y))
        dx, dy = fdiff_forward(x, 0), fdiff_forward(x, 1)
        tv = torch.sum(torch.sqrt(dx**2 + dy**2)) if self.iso else torch.sum(dx.abs()) + torch.sum(dy.abs())
        return data + self.lam * tv
