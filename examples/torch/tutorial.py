"""Executable companion of docs/TORCH.md on the card: operators ->
functionals -> solve -> a mesh -> uncertainty, end to end at 64^2.  The
twin of ``examples/tutorial.py``.

The reference scales out with its generic SPMD chain when JAX sees several
devices.  The port has no SPMD partitioner: the same ``with_shardings``
call with a spatial split of ``x`` routes the fused problem onto
``DistributedTVDeconv2D``, here on four row shards of one device (the card
repeated, or four CPU positions).

Run: python examples/torch/tutorial.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from pycsou_tpu_torch.utils.device import as_tensor, resolve_device

SHARDS = 4


def problem(shape=(64, 64), seed=0):
    """The two nested squares, the 9 x 9 Gaussian PSF (sigma 1.5) and the
    data's noise, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x_true = np.zeros(shape, np.float32)
    x_true[16:48, 16:48] = 1.0
    x_true[24:40, 24:40] = 2.0
    k = np.arange(9) - 4
    g = np.exp(-(k**2) / (2 * 1.5**2))
    psf = (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32)
    noise = 0.02 * rng.standard_normal(shape).astype(np.float32)
    return x_true, psf, noise


def build(y, psf, max_iter=1000):
    """The operators, the functionals and the PDS (``F, G, H, K``)."""
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D, Gradient
    from pycsou_tpu_torch.opt import PDS

    shape = tuple(y.shape)
    # -- operators ----------------------------------------------------------
    A = Convolve2D(shape, psf, device=y.device)
    K = Gradient(shape)
    # -- functionals (automatic gradient/prox rules) -------------------------
    F = SquaredL2Loss(shape, data=y) * A
    G = NonNegativeOrthant(shape)
    H = 0.05 * L21Norm((2,) + shape, axis=0)
    if not np.isclose(F.diff_lipschitz, 2 * A.lipschitz**2):
        raise AssertionError("the loss's Lipschitz constant must propagate through the composition")
    # -- solve ----------------------------------------------------------------
    return PDS(shape, F=F, G=G, H=H, K=K, max_iter=max_iter, accuracy_threshold=1e-5), F, G


def sampler(F, G, max_iter=1500):
    from pycsou_tpu_torch.opt import PMYULA

    return PMYULA(tuple(F.dim_shape), F=F, G=G, max_iter=max_iter, nb_burnin_iterations=300, thinning_factor=5,
                  pvalues=(0.05, 0.95), accuracy_threshold=0.0)


def main(device=None, shape=(64, 64), max_iter=1000, mc_iter=1500):
    from pycsou_tpu_torch.ops import Convolve2D
    from pycsou_tpu_torch.parallel import NamedSharding, PartitionSpec as P, make_mesh

    dev = resolve_device(device)
    x_true, psf, noise = problem(shape)
    y = Convolve2D(shape, psf, device=dev)(as_tensor(x_true, dev)) + as_tensor(noise, dev)
    solver, F, G = build(y, psf, max_iter=max_iter)
    info = solver.solve()
    x_hat = info["x"].cpu().numpy()
    err_blur = np.linalg.norm(y.cpu().numpy() - x_true) / np.linalg.norm(x_true)
    err_rec = np.linalg.norm(x_hat - x_true) / np.linalg.norm(x_true)
    if "z" not in info.diagnostics:
        raise AssertionError("the dual trajectory must be recorded")

    # -- scale out: the same expression on a mesh of row shards --------------
    mesh = make_mesh((SHARDS,), ("sp",), devices=[dev] * SHARDS)
    sharded = solver.with_shardings(x=NamedSharding(mesh, P("sp", None)),
                                    z=NamedSharding(mesh, P(None, "sp", None)))
    info_sp = sharded.solve()
    sp_diff = float(np.abs(info_sp["x"].cpu().numpy() - x_hat).max())
    if not sp_diff <= 1e-4:
        raise AssertionError(f"the sharded solve differs by {sp_diff:.3e}")

    # -- uncertainty quantification ------------------------------------------
    mc = sampler(F, G, max_iter=mc_iter)
    post = mc.solve().iterand
    std_mean = float(post["std"].mean())

    out = {"engine": solver._fused.stencil_mode, "mesh_engine": sharded._fused._sp_engine or "chain",
           "sampler_engine": mc.engine or "generic chain", "converged": bool(info.converged),
           "n_iter": info.n_iter, "err_observed": err_blur, "err": err_rec, "sharded_diff": sp_diff,
           "std_mean": std_mean}
    print(f"engines: TVDeconvolution[{out['engine']}], DistributedTVDeconv2D[{out['mesh_engine']}] on "
          f"{SHARDS} shards (max |x_sp - x| {sp_diff:.2e}), PMYULA[{out['sampler_engine']}] on {dev}")
    print(f"converged={info.converged} iters={info.n_iter} blur_err={err_blur:.3f} -> rec_err={err_rec:.3f}; "
          f"posterior mean std={std_mean:.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" for a CPU run; the card by default')
    main(device=parser.parse_args().device)
