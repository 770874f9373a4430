"""Scattered-data RBF interpolation with Green-function kernels on the card.

Fit ``f(t) = sum_j a_j phi(|t - t_j|)`` to noisy scattered samples by ridge
regression on a ``MappedDistanceMatrix`` operator with a Matern kernel
(``main``), and a compact-support Wendland fit of 50,000 points in 2-D on
the sparse backend (``main_large``).  The twin of
``examples/rbf_interpolation.py``.

Run: python examples/torch/rbf_interpolation.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from pycsou_tpu_torch.func import SquaredL2Loss, SquaredL2Norm
from pycsou_tpu_torch.math import Matern, Wendland
from pycsou_tpu_torch.ops import MappedDistanceMatrix
from pycsou_tpu_torch.opt import APGD
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device


def f_true(t):
    return np.sin(6 * np.pi * t) * np.exp(-t)


def f_true_2d(p):
    return np.sin(4 * np.pi * p[:, 0]) * np.cos(3 * np.pi * p[:, 1])


def problem(n_samples=120, n_centers=60, seed=0):
    """The sorted sample sites, their noisy values and the centres."""
    rng = np.random.default_rng(seed)
    t_obs = np.sort(rng.uniform(0, 1, n_samples)).astype(np.float32)
    y = (f_true(t_obs) + 0.05 * rng.standard_normal(n_samples).astype(np.float32)).astype(np.float32)
    centers = np.linspace(0, 1, n_centers).astype(np.float32)
    return t_obs, y, centers


def build(K, y, max_iter=2000):
    """The ridge fit ``min_a ||K a - y||^2 + 0.05 ||a||^2``."""
    m, n = K.codim_shape[0], K.dim_shape[0]
    F = SquaredL2Loss((m,), data=y) * K
    G = 0.05 * SquaredL2Norm((n,))
    return APGD((n,), F=F, G=G, max_iter=max_iter, accuracy_threshold=1e-8)


def main(device=None, max_iter=2000):
    dev = resolve_device(device)
    t_obs, y, centers = problem()
    K = MappedDistanceMatrix(t_obs, centers, Matern(k=2, epsilon=0.08), device=dev)
    K.compute_lipschitz_cst()
    info = build(K, as_tensor(y, dev), max_iter=max_iter).solve()
    a = info["x_temp"]
    # evaluate on a dense grid through a second kernel operator
    t_grid = np.linspace(0, 1, 512).astype(np.float32)
    K_grid = MappedDistanceMatrix(t_grid, centers, Matern(k=2, epsilon=0.08), device=dev)
    f_hat = K_grid(a).cpu().numpy()
    rel = np.linalg.norm(f_hat - f_true(t_grid)) / np.linalg.norm(f_true(t_grid))
    rel_obs = np.linalg.norm(y - f_true(t_obs)) / np.linalg.norm(f_true(t_obs))
    print(f"||K||={K.lipschitz:.2f} iters={info.n_iter} interpolation rel err={rel:.3f} on {dev}")
    return {"engine": "generic chain", "lipschitz": float(K.lipschitz), "n_iter": info.n_iter, "err": rel,
            "err_observed": rel_obs}


def problem_large(n=50_000, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2)).astype(np.float32)
    y = (f_true_2d(pts) + 0.02 * rng.standard_normal(n).astype(np.float32)).astype(np.float32)
    return pts, y, rng


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main_large(device=None, n=50_000, max_iter=200):
    """Compact-support Wendland fit at a size the dense backend cannot hold:
    a 50k x 50k kernel matrix would take 10 GB dense; the sparse backend
    keeps only the in-support neighbours of each point."""
    dev = resolve_device(device)
    pts, y, rng = problem_large(n)
    K = MappedDistanceMatrix(pts, pts, Wendland(k=2, epsilon=0.02), backend="sparse", device=dev)
    kmax = K._nbr_idx.shape[1]
    K.compute_lipschitz_cst(maxiter=32)
    F = SquaredL2Loss((n,), data=as_tensor(y, dev)) * K
    G = 1e-3 * SquaredL2Norm((n,))
    info = APGD((n,), F=F, G=G, max_iter=max_iter, accuracy_threshold=1e-6).solve()
    f_hat = K(info["x_temp"]).cpu().numpy()
    rel = np.linalg.norm(f_hat - f_true_2d(pts)) / np.linalg.norm(f_true_2d(pts))
    print(f"sparse MDM: n={n} kmax={kmax} (dense would be {n * n * 4 / 1e9:.0f} GB) "
          f"iters={info.n_iter} fit rel err={rel:.3f}")

    # the sparse backend against the O(m n) matrix-free one on the same kernel,
    # each matvec chained on the last one's output
    Kmf = MappedDistanceMatrix(pts, pts, Wendland(k=2, epsilon=0.02), backend="matrix-free", block=2048,
                               device=dev)
    x = as_tensor(rng.standard_normal(n).astype(np.float32), dev)
    for op in (K, Kmf):  # warm up
        op(x)
    times = {}
    for name, op, reps in (("sparse", K, 5), ("matrix-free", Kmf, 2)):
        r = x
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            r = op(r)
        _sync(dev)
        times[name] = (time.perf_counter() - t0) / reps
    print(f"matvec: sparse {times['sparse'] * 1e3:.1f} ms vs matrix-free {times['matrix-free'] * 1e3:.1f} ms "
          f"-> {times['matrix-free'] / times['sparse']:.0f}x")
    rel_obs = np.linalg.norm(y - f_true_2d(pts)) / np.linalg.norm(f_true_2d(pts))
    return {"engine": "generic chain", "kmax": int(kmax), "n_iter": info.n_iter, "err": rel, "err_observed": rel_obs,
            "matvec_ms": {k: v * 1e3 for k, v in times.items()}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    device = parser.parse_args().device
    main(device=device)
    main_large(device=device)
