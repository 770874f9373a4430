"""TV inpainting and its anisotropic variant (sampling-operator data terms)
on the card.

``min_x ||M x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})`` where M keeps a
random 40% of the pixels (a ``Masking`` data term under a TV prior).  The
expression matcher recognises ``SquaredL2Loss * Masking`` and hands the
solve to the diagonal-Gram fused engine sweepm2 (K6: two whole PDS
iterations a launch).  The anisotropic flavour (``lam * L1Norm o
Gradient``) rides the same engine.  The twin of ``examples/inpainting_tv.py``.

Run: python examples/torch/inpainting_tv.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.func import L1Norm, L21Norm, NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu_torch.ops import Gradient, Masking
from pycsou_tpu_torch.opt import PDS
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.misc import peaks

LAM = 0.02


def psnr(a, b):
    rng_v = float(np.max(b) - np.min(b))
    return 20 * np.log10(rng_v / np.sqrt(np.mean((a - b) ** 2)))


def problem(n=256, seed=0):
    """The nonnegative peaks image, the keep mask (40%) and the noise of
    the observed samples, as numpy arrays."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(g, g)
    x_true = peaks(xx.astype(np.float32), yy.astype(np.float32)).numpy()
    x_true -= x_true.min()  # nonnegative ground truth
    keep = rng.random((n, n)) < 0.4
    noise = 0.02 * rng.standard_normal(int(keep.sum())).astype(np.float32)
    return x_true, keep, noise


def build(M, y, H, max_iter=4000, accuracy_threshold=1e-5):
    n = M.dim_shape[0]
    return PDS((n, n), F=SquaredL2Loss(M.codim_shape, data=y) * M, G=NonNegativeOrthant((n, n)), H=H,
               K=Gradient((n, n)), max_iter=max_iter, accuracy_threshold=accuracy_threshold)


def penalties(n):
    return [("isotropic", LAM * L21Norm((2, n, n), axis=0)), ("anisotropic", LAM * L1Norm((2, n, n)))]


def main(device=None, n=256, max_iter=4000):
    dev = resolve_device(device)
    x_true, keep, noise = problem(n)
    M = Masking((n, n), keep, device=dev)
    y = M(as_tensor(x_true, dev)) + as_tensor(noise, dev)
    zero_fill = M.adjoint(y).cpu().numpy()

    results, engines = {}, {}
    for name, H in penalties(n):
        solver = build(M, y, H, max_iter=max_iter)
        if solver._fused is None or solver._fused.mask is None:
            raise AssertionError("the masked expression must fuse onto the diagonal-Gram engine")
        info = solver.solve()
        results[name] = info["x"].cpu().numpy()
        engines[name] = solver._fused.stencil_mode
        print(f"{name}: engine={engines[name]} iso={solver._fused.iso} "
              f"iters={info.n_iter} converged={info.converged}")

    out = {"engine": engines, "psnr_observed": psnr(zero_fill, x_true),
           "psnr": psnr(results["isotropic"], x_true), "psnr_aniso": psnr(results["anisotropic"], x_true)}
    print(f"PSNR zero-filled={out['psnr_observed']:.2f} dB -> inpainted iso={out['psnr']:.2f} dB / "
          f"aniso={out['psnr_aniso']:.2f} dB (40% pixels observed) on {dev}")
    if not (out["psnr"] > out["psnr_observed"] + 6 and out["psnr_aniso"] > out["psnr_observed"] + 6):
        raise AssertionError("inpainting must gain 6 dB over the zero-filled image")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
