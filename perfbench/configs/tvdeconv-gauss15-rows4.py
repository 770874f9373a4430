"""TV deconvolution with a 15 x 15 Gaussian PSF (sigma 2) on an image that
no single card holds, row-sharded over a four-card mesh in one process:

    PDS(F=SquaredL2Loss(y) * Convolve2D(h), G=NonNegativeOrthant,
        H=lam * L21Norm(axis=0), K=Gradient).with_shardings(
        x=NamedSharding(mesh, PartitionSpec("sp", None)))

built through the port's user API, which routes it onto
``DistributedTVDeconv2D`` (one K14 a card an iteration).  The data is
``tvdeconv-gauss15``'s: ``x_true = |N(0, 1)|`` blurred by ``h`` ('same',
zero boundary) plus ``noise_std`` N(0, 1), drawn on the first card from the
seed, the blur taken a block of rows at a time.  The mesh is the
configuration's ``mesh``: four cards where the machine has them, else four
positions of the one device (a CPU test, a one-card rehearsal)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.harness.seeding import generator

_spec = importlib.util.spec_from_file_location("perfbench_config_tvdeconv_gauss15_base",
                                               Path(__file__).with_name("tvdeconv-gauss15.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

psf = base.psf
flops_per_iter = base.flops_per_iter
bytes_per_solve = base.bytes_per_solve
BLUR_ROWS = 4096  # rows of one block of the observation's blur


class NoImageFreeNormBound(RuntimeError):
    """The program computes a convolution's norm bound by a host FFT of the
    image's size (minutes and ~70 GB of host memory at this size)."""


def mesh_devices(cfg, device) -> list:
    """The mesh's devices: as many cards as it has positions, from
    ``device`` on, where there are as many; else ``device`` repeated."""
    n = int(np.prod(cfg["mesh"]["shape"]))
    device = torch.device(device)
    if device.type == "cuda":
        first = device.index or 0
        if torch.cuda.device_count() >= first + n:
            return [torch.device("cuda", first + i) for i in range(n)]
    return [device] * n


def blur_rows(x: torch.Tensor, h: np.ndarray, r0: int, r1: int) -> torch.Tensor:
    """Rows ``[r0, r1)`` of ``tvdeconv-gauss15``'s blur of ``x`` ('same',
    zero boundary, full float32, deterministic), from those rows and the
    ``m0 // 2`` around them."""
    H, o0 = x.shape[0], h.shape[0] // 2
    lo, hi = max(0, r0 - o0), min(H, r1 + o0)
    block = F.pad(x[lo:hi], (0, 0, o0 - (r0 - lo), o0 - (hi - r1)))
    return base.blur(block, h)[o0 : o0 + r1 - r0]


def shared_inputs(cfg, shape, seed, device) -> dict:
    return {"psf": psf(cfg)}


def observation(cfg, shape, seed, index, shared, device) -> torch.Tensor:
    """``tvdeconv-gauss15``'s observation, its blur taken in row blocks:
    the noise scaled in place, then each block's blur added to it."""
    g = generator(seed, "observation", index, device=device)
    x_true = torch.randn(shape, generator=g, device=device).abs_()
    y = torch.randn(shape, generator=g, device=device).mul_(float(cfg["noise_std"]))
    for r0 in range(0, shape[0], BLUR_ROWS):
        r1 = min(shape[0], r0 + BLUR_ROWS)
        y[r0:r1] += blur_rows(x_true, shared["psf"], r0, r1)
    return y


def reference_inputs(cfg, shape, seed, index, device) -> dict:
    """The observation as row blocks on the mesh's devices, the first
    device's block on the host (``perfbench/harness/check.py`` holds four
    float64 images of the whole size on the first card beside these
    inputs), and the PSF."""
    shared = shared_inputs(cfg, shape, seed, device)
    y = observation(cfg, shape, seed, index, shared, device)
    devs = ["cpu"] + mesh_devices(cfg, device)[1:]
    h = shape[0] // len(devs)
    blocks = tuple(y[i * h : (i + 1) * h].to(d, copy=True) for i, d in enumerate(devs))
    del y
    return {"y": blocks, "psf": shared["psf"]}


def instrument(cfg, shape, shared, device) -> dict:
    """What a user with one instrument builds once: ``A``, the prior and the
    mesh.  First, before anything of the image's size, a program without a
    norm bound free of the image's size (``ops.conv.fft_norm_bound``) is
    refused: its ``Convolve2D`` would spend minutes in a host FFT here."""
    from pycsou_tpu_torch.ops import conv

    if not hasattr(conv, "fft_norm_bound"):
        raise NoImageFreeNormBound(
            f"pycsou_tpu_torch.ops.conv has no fft_norm_bound: Convolve2D{tuple(shape)} would take the norm "
            "bound from a float64 host FFT of the whole padded image")
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant
    from pycsou_tpu_torch.ops import Convolve2D, Gradient
    from pycsou_tpu_torch.parallel import make_mesh

    mesh = make_mesh(tuple(cfg["mesh"]["shape"]), (cfg["mesh"]["axis"],), devices=mesh_devices(cfg, device))
    return {"A": Convolve2D(shape, shared["psf"], device=device), "G": NonNegativeOrthant(shape),
            "H": float(cfg["lam"]) * L21Norm((2,) + tuple(shape), axis=0), "K": Gradient(shape), "mesh": mesh}


def build(cfg, traffic, shape, inst, y):
    """The user's ``PDS``, routed over the mesh by ``with_shardings``."""
    from pycsou_tpu_torch.func import SquaredL2Loss
    from pycsou_tpu_torch.opt import PDS
    from pycsou_tpu_torch.parallel import NamedSharding, PartitionSpec

    pds = PDS(shape, F=SquaredL2Loss(shape, data=y) * inst["A"], G=inst["G"], H=inst["H"], K=inst["K"],
              max_iter=int(traffic["max_iter"]), min_iter=int(traffic["min_iter"]),
              accuracy_threshold=float(traffic["tol"]))
    return pds.with_shardings(x=NamedSharding(inst["mesh"], PartitionSpec(cfg["mesh"]["axis"], None)))


def shard_bytes_per_launch(cfg, shape) -> float:
    """K14's bytes a launch, counted low: the shard's seven core planes
    (``x``, ``z0``, ``z1``, ``A^H y`` read; ``x``, ``z0``, ``z1`` written)
    once, 28 B a pixel; the halos and the taps left out."""
    n = int(np.prod(cfg["mesh"]["shape"]))
    return 7 * 4 * (shape[0] // n) * shape[1]


def shard_flops_per_launch(cfg, shape) -> float:
    """K14's float32 operations a launch: the shard's share of an
    iteration's (:func:`flops_per_iter`, counted low)."""
    n = int(np.prod(cfg["mesh"]["shape"]))
    return flops_per_iter(cfg, shape) / n
