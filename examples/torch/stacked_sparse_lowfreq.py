"""Stacked-operator sparse + low-frequency recovery (BASELINE config 4) on
the card.

Measurements ``y = VStack(Masking, DCT-lowpass) x`` of a DCT-sparse signal;
recovery ``min_x ||K x - y||^2 + lam ||DCT x||_1``, the penalty's prox exact
through the unitary precomposition rule and the stack's norm from a power
iteration on the device.  The twin of ``examples/stacked_sparse_lowfreq.py``.

Run: python examples/torch/stacked_sparse_lowfreq.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
from pycsou_tpu_torch.ops import DCTOperator, LinOpVStack, Masking, SubSampling
from pycsou_tpu_torch.opt import APGD
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device


def problem(n=512, seed=0):
    """The DCT coefficients (20 of the first 200), the 30% time-domain
    sampling mask, and the generator that draws the data's noise next."""
    rng = np.random.default_rng(seed)
    c_true = np.zeros(n, np.float32)
    c_true[rng.choice(200, 20, replace=False)] = rng.standard_normal(20).astype(np.float32)
    mask = rng.uniform(size=n) < 0.3
    return c_true, mask, rng


def build(n, mask, device):
    """The DCT, the time-domain samples ``M`` and the stack ``[M;
    SubSampling(32) o DCT]`` with its norm from the power iteration."""
    dct = DCTOperator((n,), device=device)
    M = Masking((n,), mask, device=device)  # random time-domain samples
    P = SubSampling((n,), np.arange(32), device=device)  # the low-frequency band
    K = LinOpVStack([M, P * dct])
    K.compute_lipschitz_cst()  # power iteration on the device (the step size)
    return dct, M, K


def solver_for(K, dct, y, max_iter=4000, accuracy_threshold=1e-9, verbose=1000):
    n = dct.dim_shape[0]
    F = SquaredL2Loss(K.codim_shape, data=y) * K
    G = 0.01 * (L1Norm((n,)) * dct)  # prox by the unitary rule: U^H soft(U x)
    return APGD((n,), F=F, G=G, max_iter=max_iter, accuracy_threshold=accuracy_threshold, verbose=verbose)


def main(device=None, n=512, max_iter=4000, verbose=1000):
    dev = resolve_device(device)
    c_true, mask, rng = problem(n)
    dct, M, K = build(n, mask, dev)
    x_true = dct.adjoint(as_tensor(c_true, dev))
    y = K(x_true)
    y = y + 0.005 * as_tensor(rng.standard_normal(tuple(y.shape)).astype(np.float32), dev)
    solver = solver_for(K, dct, y, max_iter=max_iter, verbose=verbose)
    info = solver.solve()
    x = info["x_temp"]
    rel = float(((x - x_true).norm() / x_true.norm()).cpu())
    # the observation: the time-domain samples, zero-filled (noise-free)
    rel_obs = float(((M.adjoint(M(x_true)) - x_true).norm() / x_true.norm()).cpu())
    out = {"engine": "generic chain", "lipschitz": float(K.lipschitz), "n_iter": info.n_iter, "err": rel,
           "err_observed": rel_obs}
    print(f"engine: APGD[generic chain] on {dev}")
    print(f"||K||={K.lipschitz:.3f} iters={info.n_iter} rel err={rel:.3f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
