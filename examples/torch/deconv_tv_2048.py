"""Non-blind 2-D image deconvolution with TV + nonnegativity (BASELINE
config 3) on the card: ``min_x ||h*x - y||^2 + lam ||grad x||_{2,1} +
i_{x>=0}`` at 2048^2 with Condat-Vu PDS, an 11 x 11 Gaussian PSF.  The
expression fuses onto ``TVDeconvolution``; the ladder takes mega3 (K10, two
iterations a launch) for this rank-1 PSF, after one K1 launch for
``A^H y``.  The twin of ``examples/deconv_tv_2048.py``.

Run: python examples/torch/deconv_tv_2048.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu_torch.ops import Convolve2D, Gradient
from pycsou_tpu_torch.opt import PDS
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.misc import peaks

LAM = 0.002


def problem(n=2048, seed=0):
    """The clean peaks image (clipped at 0), the 11 x 11 Gaussian PSF and
    the noise of the data ``y = h*x + noise``, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(g, g)
    clean = np.maximum(peaks(xx.astype(np.float32), yy.astype(np.float32)).numpy(), 0)
    k = np.arange(11) - 5
    gk = np.exp(-(k**2) / 6)
    h = np.outer(gk, gk).astype(np.float32)
    h /= h.sum()
    noise = 0.005 * rng.standard_normal((n, n)).astype(np.float32)
    return clean, h, noise


def build(y, h, max_iter=300, accuracy_threshold=1e-6, verbose=50):
    """The PDS of the problem on ``y``'s device (``A`` the PSF's
    convolution)."""
    n = y.shape[0]
    A = Convolve2D((n, n), h, device=y.device)
    F = SquaredL2Loss((n, n), data=y) * A  # -> LeastSquaresLoss (fused Gram)
    K = Gradient((n, n))
    H = LAM * L21Norm((2, n, n), axis=0)
    return PDS((n, n), F=F, G=NonNegativeOrthant((n, n)), H=H, K=K, max_iter=max_iter,
               accuracy_threshold=accuracy_threshold, verbose=verbose)


def psnr(a, clean):
    return 10 * np.log10(clean.max() ** 2 / np.mean((a - clean) ** 2))


def main(device=None, n=2048, max_iter=300, verbose=50):
    dev = resolve_device(device)
    clean, h, noise = problem(n)
    A = Convolve2D((n, n), h, device=dev)
    y = A(as_tensor(clean, dev)) + as_tensor(noise, dev)

    solver = build(y, h, max_iter=max_iter, verbose=verbose)
    t0 = time.perf_counter()
    info = solver.solve()
    x = info["x"].cpu().numpy()
    dt = time.perf_counter() - t0
    out = {"engine": solver._fused.stencil_mode, "n_iter": info.n_iter, "seconds": dt,
           "psnr_observed": psnr(y.cpu().numpy(), clean), "psnr": psnr(x, clean)}
    print(f"engine: TVDeconvolution[{out['engine']}] on {dev}")
    print(f"iters={info.n_iter} in {dt:.1f}s ({info.n_iter / dt:.1f} it/s) "
          f"PSNR blurred={out['psnr_observed']:.2f} dB -> deconvolved={out['psnr']:.2f} dB")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
