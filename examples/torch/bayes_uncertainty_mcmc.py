"""Bayesian uncertainty quantification with PMYULA on the card.

Sample the posterior of a sparse 1-D deconvolution problem and report the
MMSE and pointwise credible intervals from the streaming P^2 quantiles.
The sampler's noise is Philox keyed by (seed, sample), so the samples are
not the reference's; their statistics are.  The twin of
``examples/bayes_uncertainty_mcmc.py``.

Run: python examples/torch/bayes_uncertainty_mcmc.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
from pycsou_tpu_torch.ops import Convolve1D
from pycsou_tpu_torch.opt.mcmc import PMYULA
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device

SIGMA = 0.05


def problem(n=128, seed=1):
    """Six spikes of height 2, the 13-tap Gaussian and the data's noise."""
    rng = np.random.default_rng(seed)
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, 6, replace=False)] = 2.0
    t = np.arange(-6, 7)
    h = np.exp(-(t**2) / 6).astype(np.float32)
    h /= h.sum()
    noise = SIGMA * rng.standard_normal(n).astype(np.float32)
    return x_true, h, noise


def build(A, y, nb_burnin_iterations=2000, n_samples=20000):
    n = A.dim_shape[0]
    # -log posterior = ||Ax - y||^2 / (2 sigma^2) + lam |x|_1
    F = (1.0 / (2 * SIGMA**2)) * (SquaredL2Loss((n,), data=y) * A)
    G = 10.0 * L1Norm((n,))
    return PMYULA((n,), F=F, G=G, nb_burnin_iterations=nb_burnin_iterations, max_iter=n_samples,
                  min_iter=n_samples, accuracy_threshold=0.0, pvalues=(0.025, 0.5, 0.975), seed=0,
                  device=y.device)


def main(device=None, n=128, n_samples=20000, nb_burnin_iterations=2000):
    dev = resolve_device(device)
    x_true, h, noise = problem(n)
    A = Convolve1D((n,), h, device=dev)
    y = A(as_tensor(x_true, dev)) + as_tensor(noise, dev)
    sampler = build(A, y, nb_burnin_iterations=nb_burnin_iterations, n_samples=n_samples)
    out = sampler.solve().iterand
    mmse = out["mmse"].cpu().numpy()
    lo, hi = out["quantiles"][0.025].cpu().numpy(), out["quantiles"][0.975].cpu().numpy()
    inside = float(np.mean((x_true >= lo) & (x_true <= hi)))
    rel = np.linalg.norm(mmse - x_true) / np.linalg.norm(x_true)
    res = {"engine": sampler.engine or "generic chain", "samples": int(out["n_samples"]), "err": rel,
           "err_observed": np.linalg.norm(y.cpu().numpy() - x_true) / np.linalg.norm(x_true),
           "coverage": inside}
    print(f"engine: PMYULA[{res['engine']}] on {dev}")
    print(f"samples={res['samples']} mmse rel err={rel:.3f} 95% CI coverage={inside:.2%}")
    return res


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
