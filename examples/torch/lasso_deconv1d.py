"""LASSO 1-D deconvolution (BASELINE config 1) on the card.

Sparse spike recovery: ``min_x ||h * x - y||^2 + lam ||x||_1`` solved with
APGD/FISTA on a 256-sample ``Convolve1D``.  The twin of
``examples/lasso_deconv1d.py``.

Run: python examples/torch/lasso_deconv1d.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
from pycsou_tpu_torch.ops import Convolve1D
from pycsou_tpu_torch.opt import APGD
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device

LAM = 0.005


def problem(n=256, seed=0):
    """12 sparse spikes, the 21-tap Gaussian kernel and the data's noise,
    as numpy arrays (and the spikes' indices)."""
    rng = np.random.default_rng(seed)
    x_true = np.zeros(n, np.float32)
    idx = rng.choice(n, 12, replace=False)
    x_true[idx] = rng.standard_normal(12).astype(np.float32) * 2
    t = np.arange(-10, 11)
    h = np.exp(-(t**2) / 8).astype(np.float32)
    h /= h.sum()
    noise = 0.01 * rng.standard_normal(n).astype(np.float32)
    return x_true, h, noise, idx


def build(A, y, max_iter=2000, accuracy_threshold=1e-7, verbose=200):
    n = A.dim_shape[0]
    F = SquaredL2Loss((n,), data=y) * A  # beta = 2 ||A||^2, propagated
    G = LAM * L1Norm((n,))
    return APGD((n,), F=F, G=G, acceleration="CD", max_iter=max_iter, accuracy_threshold=accuracy_threshold,
                verbose=verbose)


def main(device=None, n=256, max_iter=2000, verbose=200):
    dev = resolve_device(device)
    x_true, h, noise, idx = problem(n)
    A = Convolve1D((n,), h, device=dev)  # exact ||A|| from max |FFT(h)|
    y = A(as_tensor(x_true, dev)) + as_tensor(noise, dev)
    solver = build(A, y, max_iter=max_iter, verbose=verbose)
    info = solver.solve()
    x_rec = info["x_temp"].cpu().numpy()
    err = np.linalg.norm(x_rec - x_true) / np.linalg.norm(x_true)
    support = int(np.sum((np.abs(x_rec) > 0.05) & (np.abs(x_true) > 0)))
    out = {"engine": "generic chain" if solver._fused is None else solver._fused.engine, "n_iter": info.n_iter,
           "converged": bool(info.converged), "err": err, "support": support, "spikes": len(idx),
           "err_observed": np.linalg.norm(y.cpu().numpy() - x_true) / np.linalg.norm(x_true)}
    print(f"engine: APGD[{out['engine']}] on {dev}")
    print(f"converged={info.converged} iters={info.n_iter} rel_err={err:.3f}")
    print(f"support recovered: {support}/{len(idx)}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
