"""Consensus-ADMM block-partitioned 3-D deconvolution across scenarios
(BASELINE config 5) on the card.

Each mesh position holds one blurred observation of the same 32^3 volume
(a different PSF each); the consensus variable is the mean of the blocks'
sums, folded in mesh order, and each scenario's x-update is an exact
FFT-domain solve.  The reference runs one scenario a device of JAX's mesh
(8 on its virtual CPU mesh); here the ``dp`` mesh is 8 positions of one
device (the card repeated, or the CPU).  The twin of
``examples/consensus_admm_3d.py``.

Run: python examples/torch/consensus_admm_3d.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np
import torch

from pycsou_tpu_torch.func import NonNegativeOrthant
from pycsou_tpu_torch.ops import CircularConvolve
from pycsou_tpu_torch.opt.admm import ConsensusADMM
from pycsou_tpu_torch.parallel import make_mesh
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device


def problem(shape=(32, 32, 32), seed=0):
    """Ten bright 4^3 blobs, and the generator that draws the scenarios'
    noise next."""
    rng = np.random.default_rng(seed)
    x_true = np.zeros(shape, np.float32)
    for _ in range(10):  # random bright blobs
        c = rng.integers(4, 28, size=3)
        x_true[c[0] - 2 : c[0] + 2, c[1] - 2 : c[1] + 2, c[2] - 2 : c[2] + 2] = 1.0
    return x_true, rng


def psf(s):
    """Scenario ``s``'s 5^3 Gaussian, wider with s."""
    k = np.arange(5) - 2
    g = np.exp(-(k**2) / (1.0 + 0.3 * s))
    h = np.einsum("i,j,k->ijk", g, g, g).astype(np.float32)
    return h / h.sum()


def scenarios(x_true, rng, n, device):
    """Each scenario's transfer function and blurred noisy observation."""
    shape = x_true.shape
    h_hats, ys = [], []
    for s in range(n):
        op = CircularConvolve(shape, psf(s), device=device)
        h_hats.append(op.h_hat)
        ys.append(op(as_tensor(x_true, device)).cpu().numpy()
                  + 0.01 * rng.standard_normal(shape).astype(np.float32))
    return torch.stack(h_hats), np.stack(ys)


def build(shape, h_hats, ys, mesh):
    return ConsensusADMM(shape, h_hats, ys, g=NonNegativeOrthant(shape), rho=0.5, mesh=mesh)


def main(device=None, shape=(32, 32, 32), n_scenarios=8, n_iter=100):
    dev = resolve_device(device)
    mesh = make_mesh((n_scenarios,), ("dp",), devices=[dev] * n_scenarios)
    x_true, rng = problem(shape)
    h_hats, ys = scenarios(x_true, rng, n_scenarios, dev)
    admm = build(shape, h_hats, ys, mesh)
    z = admm.run(n_iter).cpu().numpy()
    rel = np.linalg.norm(z - x_true) / np.linalg.norm(x_true)
    rel_obs = np.linalg.norm(ys[0] - x_true) / np.linalg.norm(x_true)
    out = {"engine": "consensus ADMM (Fourier x-update)", "scenarios": n_scenarios, "err": rel,
           "err_observed": rel_obs}
    print(f"devices={n_scenarios} positions of {dev} scenarios={n_scenarios} rel err={rel:.3f} "
          f"(first observation {rel_obs:.3f})")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
