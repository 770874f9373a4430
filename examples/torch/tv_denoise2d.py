"""2-D isotropic TV denoising (BASELINE config 2) on the card.

``min_x ||x - y||^2 + lam ||grad x||_{2,1}`` with Condat-Vu PDS at 512^2.
The expression fuses onto ``TVDeconvolution`` as the identity 1 x 1
convolution (conv mode), so the ladder's pick runs it.  The twin of
``examples/tv_denoise2d.py``.

Run: python examples/torch/tv_denoise2d.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.func import L21Norm, SquaredL2Loss
from pycsou_tpu_torch.ops import Gradient
from pycsou_tpu_torch.opt import PDS
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.misc import peaks

LAM = 0.8


def problem(n=512, seed=0):
    """The clean peaks image and its noisy copy (sigma 0.5), numpy."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(g, g)
    clean = peaks(xx.astype(np.float32), yy.astype(np.float32)).numpy()
    noisy = clean + 0.5 * rng.standard_normal((n, n)).astype(np.float32)
    return clean, noisy


def build(noisy, max_iter=500, accuracy_threshold=1e-5, verbose=100):
    n = noisy.shape[0]
    K = Gradient((n, n))  # ||K|| <= sqrt(8), set in closed form
    F = SquaredL2Loss((n, n), data=noisy)
    H = LAM * L21Norm((2, n, n), axis=0)  # isotropic TV
    return PDS((n, n), F=F, H=H, K=K, max_iter=max_iter, accuracy_threshold=accuracy_threshold, verbose=verbose)


def psnr(a, clean):
    return 10 * np.log10((clean.max() - clean.min()) ** 2 / np.mean((a - clean) ** 2))


def main(device=None, n=512, max_iter=500, verbose=100):
    dev = resolve_device(device)
    clean, noisy = problem(n)
    solver = build(as_tensor(noisy, dev), max_iter=max_iter, verbose=verbose)
    info = solver.solve()
    x = info["x"].cpu().numpy()
    out = {"engine": solver._fused.stencil_mode, "n_iter": info.n_iter,
           "psnr_observed": psnr(noisy, clean), "psnr": psnr(x, clean)}
    print(f"engine: TVDeconvolution[{out['engine']}] on {dev}")
    print(f"iters={info.n_iter} PSNR noisy={out['psnr_observed']:.2f} dB -> denoised={out['psnr']:.2f} dB")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
