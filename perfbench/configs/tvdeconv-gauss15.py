"""TV deconvolution with a 15 x 15 Gaussian PSF (sigma 2):

    PDS(F=SquaredL2Loss(y) * Convolve2D(h), G=NonNegativeOrthant,
        H=lam * L21Norm(axis=0), K=Gradient)

built through the port's user API, which fuses it onto
``TVDeconvolution``.  The data is ``bench.py make_problem``'s: ``x_true =
|N(0, 1)|`` blurred by ``h`` ('same', zero boundary), plus ``noise_std``
N(0, 1), drawn on the device from the seed and the observation's index."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.harness.seeding import generator


def psf(cfg) -> np.ndarray:
    """``bench.py gaussian_kernel``: the normalised outer product, float32."""
    k, s = int(cfg["psf"]["taps"]), float(cfg["psf"]["sigma"])
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def blur(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """'Same', zero-boundary convolution of ``x`` by an odd-sized ``h``, at
    full float32 (no TF32) and deterministic."""
    hk = torch.as_tensor(np.ascontiguousarray(h[::-1, ::-1]), device=x.device)[None, None]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        return F.conv2d(x[None, None], hk, padding=(h.shape[0] // 2, h.shape[1] // 2))[0, 0]


def shared_inputs(cfg, shape, seed, device) -> dict:
    return {"psf": psf(cfg)}


def observation(cfg, shape, seed, index, shared, device) -> torch.Tensor:
    g = generator(seed, "observation", index, device=device)
    x_true = torch.randn(shape, generator=g, device=device).abs_()
    noise = torch.randn(shape, generator=g, device=device)
    return blur(x_true, shared["psf"]) + float(cfg["noise_std"]) * noise


def reference_inputs(cfg, shape, seed, index, device) -> dict:
    shared = shared_inputs(cfg, shape, seed, device)
    return {"y": observation(cfg, shape, seed, index, shared, device), "psf": shared["psf"]}


def instrument(cfg, shape, shared, device) -> dict:
    """What a user with one instrument builds once: ``A`` and the prior."""
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant
    from pycsou_tpu_torch.ops import Convolve2D, Gradient

    return {"A": Convolve2D(shape, shared["psf"], device=device), "G": NonNegativeOrthant(shape),
            "H": float(cfg["lam"]) * L21Norm((2,) + tuple(shape), axis=0), "K": Gradient(shape)}


def build(cfg, traffic, shape, inst, y):
    from pycsou_tpu_torch.func import SquaredL2Loss
    from pycsou_tpu_torch.opt import PDS

    return PDS(shape, F=SquaredL2Loss(shape, data=y) * inst["A"], G=inst["G"], H=inst["H"], K=inst["K"],
               max_iter=int(traffic["max_iter"]), min_iter=int(traffic["min_iter"]),
               accuracy_threshold=float(traffic["tol"]))


def flops_per_iter(cfg, shape) -> float:
    """The least float32 operations of one iteration, counted low (the
    derivation is in PERF.md): the rank-1 Gram as the symmetric
    ``2 m - 1``-tap autocorrelation along each axis, symmetric taps counted
    once (``3 m - 2`` a pixel an axis), the data gradient (2), the isotropic
    TV step with the clamp and the relaxation (32), and the six stopping
    sums once in two iterations (7.5)."""
    m = int(cfg["psf"]["taps"])
    return (2 * (3 * m - 2) + 2 + 32 + 7.5) * shape[0] * shape[1]


def bytes_per_solve(cfg, shape) -> float:
    """The solve's own input (``y``) read once and ``x`` written once."""
    return 2 * 4 * shape[0] * shape[1]
