"""Non-Gaussian (rank-2 PSF) deblurring on the card: defocus + horizontal
motion.

Real camera blurs are rarely isotropic Gaussians: a defocus disc plus a
motion streak gives a PSF of numerical rank 2-3.  ``TVDeconvolution``
finds the low-rank structure and runs the fused rank-r engine megar (K4:
forward sweep -> adjoint sweep -> PDS stencil in one launch an iteration),
after one K1 launch for ``A^H y``; on the CPU it runs the plain engine,
the same math.  The twin of ``examples/motion_deblur_rank2.py``.

Run: python examples/torch/motion_deblur_rank2.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.ops.conv import Convolve2D, lowrank_factors
from pycsou_tpu_torch.opt.tv import TVDeconvolution
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.misc import peaks

LAM = 0.002


def problem(n=1024, seed=0):
    """The piecewise-constant scene (rounded peaks, clipped at 0), the
    defocus + motion PSF and the data's noise, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(g, g)
    smooth = peaks(xx.astype(np.float32), yy.astype(np.float32)).numpy()
    # sharp edges: where motion blur hurts and the TV prior helps
    clean = np.maximum(np.round(smooth), 0).astype(np.float32)
    # defocus (isotropic Gaussian) + horizontal motion (wide flat streak)
    k = np.arange(11) - 5
    defocus = np.exp(-(k**2) / 4.0)
    h = np.outer(defocus, defocus) + 0.5 * np.outer(np.exp(-(k**2) / 0.8), np.exp(-(k**2) / 30.0))
    h = (h / h.sum()).astype(np.float32)
    noise = 0.005 * rng.standard_normal((n, n)).astype(np.float32)
    return clean, h, noise


def build(y, h, max_iter=300, accuracy_threshold=1e-6, verbose=100):
    n = y.shape[0]
    return TVDeconvolution((n, n), y, lam=LAM, filt=h, nonneg=True, max_iter=max_iter,
                           accuracy_threshold=accuracy_threshold, verbose=verbose)


def psnr(a, clean):
    return 10 * np.log10(clean.max() ** 2 / np.mean((a - clean) ** 2))


def main(device=None, n=1024, max_iter=300, verbose=100):
    dev = resolve_device(device)
    clean, h, noise = problem(n)
    us, _ = lowrank_factors(h)
    print(f"PSF numerical rank: {us.shape[1]}")
    A = Convolve2D((n, n), h, device=dev)
    y = A(as_tensor(clean, dev)) + as_tensor(noise, dev)

    solver = build(y, h, max_iter=max_iter, verbose=verbose)
    print(f"engine: {solver.stencil_mode} on {dev}")
    t0 = time.perf_counter()
    info = solver.solve()
    x = info["x"].cpu().numpy()
    dt = time.perf_counter() - t0
    out = {"engine": solver.stencil_mode, "rank": int(us.shape[1]), "n_iter": info.n_iter, "seconds": dt,
           "psnr_observed": psnr(y.cpu().numpy(), clean), "psnr": psnr(x, clean)}
    print(f"iters={info.n_iter} in {dt:.1f}s ({info.n_iter / dt:.1f} it/s) "
          f"PSNR blurred={out['psnr_observed']:.2f} dB -> deblurred={out['psnr']:.2f} dB")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
