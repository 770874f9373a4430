"""TV inpainting behind a fixed dead-pixel map:

    PDS(F=SquaredL2Loss(y) * Masking(mask), G=NonNegativeOrthant,
        H=lam * L21Norm(axis=0), K=Gradient)

built through the port's user API, which fuses it onto
``TVDeconvolution``'s mask mode.  The keep mask is ``U(0, 1) < keep``,
drawn once from the seed (a sensor's map); an image is ``chip_smoke.py
blocks_image``'s piecewise-constant kind (``block``-pixel blocks of
|N(0, 1)| levels) plus ``noise_std`` N(0, 1), and ``y`` its kept pixels in
row-major order, all drawn on the device from the seed and the index."""
from __future__ import annotations

import torch

from perfbench.harness.seeding import generator


def shared_inputs(cfg, shape, seed, device) -> dict:
    g = generator(seed, "mask", device=device)
    return {"mask": torch.rand(shape, generator=g, device=device) < float(cfg["keep"])}


def observation(cfg, shape, seed, index, shared, device) -> torch.Tensor:
    b = int(cfg["block"])
    g = generator(seed, "observation", index, device=device)
    levels = torch.randn((-(-shape[0] // b), -(-shape[1] // b)), generator=g, device=device).abs_()
    img = levels.repeat_interleave(b, 0).repeat_interleave(b, 1)[: shape[0], : shape[1]]
    noise = torch.randn(shape, generator=g, device=device)
    return (img + float(cfg["noise_std"]) * noise)[shared["mask"]]


def reference_inputs(cfg, shape, seed, index, device) -> dict:
    shared = shared_inputs(cfg, shape, seed, device)
    return {"y": observation(cfg, shape, seed, index, shared, device), "mask": shared["mask"]}


def instrument(cfg, shape, shared, device) -> dict:
    """What a user with one sensor builds once: the sampling and the prior."""
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant
    from pycsou_tpu_torch.ops import Gradient
    from pycsou_tpu_torch.ops.sampling import Masking

    return {"A": Masking(shape, shared["mask"], device=device), "G": NonNegativeOrthant(shape),
            "H": float(cfg["lam"]) * L21Norm((2,) + tuple(shape), axis=0), "K": Gradient(shape)}


def build(cfg, traffic, shape, inst, y):
    from pycsou_tpu_torch.func import SquaredL2Loss
    from pycsou_tpu_torch.opt import PDS

    return PDS(shape, F=SquaredL2Loss(tuple(y.shape), data=y) * inst["A"], G=inst["G"], H=inst["H"],
               K=inst["K"], max_iter=int(traffic["max_iter"]), min_iter=int(traffic["min_iter"]),
               accuracy_threshold=float(traffic["tol"]))


def flops_per_iter(cfg, shape) -> float:
    """The least float32 operations of one iteration, counted low (PERF.md):
    the diagonal Gram's gradient ``2 (m x - A^H y)`` (3), the isotropic TV
    step with the clamp and the relaxation (32), and the six stopping sums
    once in two iterations (7.5)."""
    return (3 + 32 + 7.5) * shape[0] * shape[1]


def bytes_per_solve(cfg, shape) -> float:
    """The solve's own inputs read once (``A^H y`` in float32, the keep mask
    at one byte) and ``x`` written once."""
    return (4 + 1 + 4) * shape[0] * shape[1]
