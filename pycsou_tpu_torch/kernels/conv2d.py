"""Separable low-rank 'same' 2-D convolution (K1) and its fused Gram (K2).

``y = sum_i C(v_i) R(u_i) x``: the 'same', zero-boundary convolution of an
(H, W) image with a PSF of rank <= 4, ``filt = sum_i u_i v_i^T``, where
``y[p] = sum_k h[k] x[p + o - k]`` and ``o = K // 2`` on each axis.  The
adjoint is the correlation: flipped taps at the offset ``K - 1 - o``
(:meth:`SepFactors.adjoint`).

Each kernel has beside it a plain PyTorch version (the CPU path, and the
reference the card's kernel is held against) and a launch counter
(``<wrapper>.launches``).  A wrapper runs the plain version only for a CPU
tensor; on a CUDA tensor it launches the kernel or raises.

Gates: rank <= 4 and at most 31 taps per axis (a reach of 15 on either
side), for every image size; beyond them the wrappers raise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pycsou_tpu_torch.kernels._build import check, library, stream_of
from pycsou_tpu_torch.utils.device import full_f32

__all__ = [
    "MAX_RANK",
    "MAX_TAPS",
    "SepFactors",
    "gram_taps",
    "sepconv2d",
    "sepconv2d_plain",
    "sepgram2d",
    "sepgram2d_plain",
]

MAX_RANK = 4
MAX_TAPS = 31


class SepFactors:
    """Factor taps ``u`` (Ku, rank) and ``v`` (Kv, rank) of a separable PSF
    with their 'same' offsets, on one device, plus the packed
    ``[u^T | v^T]`` host buffer the kernels' launchers copy into the
    kernels' parameters."""

    def __init__(self, u, v, ou: int, ov: int, device):
        u, v = np.asarray(u, np.float32), np.asarray(v, np.float32)
        if u.ndim == 1:
            u = u[:, None]
        if v.ndim == 1:
            v = v[:, None]
        packed = np.concatenate([u.T.reshape(-1), v.T.reshape(-1)])
        u, v = torch.as_tensor(u, device=device), torch.as_tensor(v, device=device)
        rank = u.shape[1]
        if rank != v.shape[1] or not 1 <= rank <= MAX_RANK:
            raise ValueError(f"factor ranks {u.shape[1]}/{v.shape[1]}: need equal and <= {MAX_RANK}")
        Ku, Kv = u.shape[0], v.shape[0]
        if Ku > MAX_TAPS or Kv > MAX_TAPS:
            raise ValueError(f"{Ku}x{Kv} taps: the kernels take at most {MAX_TAPS} per axis")
        if not (0 <= ou < Ku and 0 <= ov < Kv):
            raise ValueError(f"offsets ({ou}, {ov}) outside the {Ku}x{Kv} taps")
        self.u, self.v = u, v
        self.ou, self.ov = int(ou), int(ov)
        self.rank, self.Ku, self.Kv = rank, Ku, Kv
        self.packed = packed
        # set on an adjoint stack: its forward stack, and [fwd | adj] packed
        # for the Gram kernels (built once, not per launch)
        self.of = None
        self.pair = None

    @property
    def device(self) -> torch.device:
        return self.u.device

    def adjoint(self, scale: float = 1.0) -> "SepFactors":
        """The adjoint (correlation) stack: flipped taps at ``K - 1 - o``,
        with ``scale`` folded into the row taps (exact for a power of 2)."""
        u = scale * self.u.flip(0)
        adj = SepFactors(
            u.cpu().numpy(), self.v.flip(0).cpu().numpy(),
            self.Ku - 1 - self.ou, self.Kv - 1 - self.ov, self.device,
        )
        adj.of = self
        adj.pair = np.concatenate([self.packed, adj.packed])
        return adj


def gram_taps(fwd: SepFactors, adj: SepFactors) -> np.ndarray:
    """``[fwd | adj]`` packed host taps for the Gram kernels (cached on
    ``adj``)."""
    if (adj.rank, adj.Ku, adj.Kv) != (fwd.rank, fwd.Ku, fwd.Kv):
        raise ValueError("adj must be the adjoint stack of fwd (same rank and tap counts)")
    return adj.pair if adj.of is fwd else np.concatenate([fwd.packed, adj.packed])


def _check_image(t: torch.Tensor, name: str, like: torch.Tensor = None) -> None:
    if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 2-D float32 tensor, got {t.dtype} {tuple(t.shape)}")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, expected {tuple(like.shape)} on {like.device}")


def _check_device(x: torch.Tensor, *factors: SepFactors) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    for f in factors:
        if f.device != x.device:
            raise ValueError(f"factor taps on {f.device}, image on {x.device}")


# -- plain versions ----------------------------------------------------------


def sepconv2d_plain(x: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """Plain PyTorch version of K1.  ``F.conv2d`` is a cross-correlation,
    so the taps are flipped and the padding is ``K - 1 - o`` before and
    ``o`` after (asymmetric for even K).  Full f32 (no TF32) on the card."""
    r = f.rank
    w_row = f.u.T.flip(-1).reshape(r, 1, f.Ku, 1)
    w_col = f.v.T.flip(-1).reshape(r, 1, 1, f.Kv)
    with full_f32():
        t = F.conv2d(F.pad(x[None, None], (0, 0, f.Ku - 1 - f.ou, f.ou)), w_row)
        y = F.conv2d(F.pad(t, (f.Kv - 1 - f.ov, f.ov, 0, 0)), w_col, groups=r)
    return y.sum(dim=1)[0]


def sepgram2d_plain(x, fwd: SepFactors, adj: SepFactors, atb=None) -> torch.Tensor:
    """Plain PyTorch version of K2: ``adj(fwd(x))``, minus ``2 atb`` when
    ``atb`` is given (``adj`` then carries the gradient's 2x)."""
    g = sepconv2d_plain(sepconv2d_plain(x, fwd), adj)
    return g if atb is None else g - 2.0 * atb


# -- kernels -----------------------------------------------------------------


def sepconv2d(x: torch.Tensor, f: SepFactors) -> torch.Tensor:
    """K1: ``sum_i C(v_i) R(u_i) x``.

    Replaces ``pycsou_tpu/kernels/conv2d.py`` ``sepconv2d_sweep``.  Bound by
    device memory: 2 image streams (x in, y out), halos from L2."""
    _check_image(x, "x")
    _check_device(x, f)
    if x.device.type == "cpu":
        return sepconv2d_plain(x, f)
    H, W = x.shape
    y = torch.empty_like(x)
    err = library().pct_sepconv2d(
        x.data_ptr(), y.data_ptr(), H, W, f.packed.ctypes.data,
        f.rank, f.Ku, f.Kv, f.ou, f.ov, stream_of(x),
    )
    check(err, "sepconv2d")
    sepconv2d.launches += 1
    return y


sepconv2d.launches = 0


def sepgram2d(x: torch.Tensor, fwd: SepFactors, adj: SepFactors, atb=None) -> torch.Tensor:
    """K2: the Gram ``adj(fwd(x))`` in one pass, or the least-squares
    gradient ``adj(fwd(x)) - 2 atb`` when ``atb`` is given and ``adj``
    carries the 2x (``fwd.adjoint(2.0)``).  t = fwd(x) never reaches device
    memory.

    Replaces ``pycsou_tpu/kernels/conv2d.py`` ``sepgram2d_sweep``.  Bound
    by device memory: 2 image streams, 3 with ``atb``."""
    _check_image(x, "x")
    _check_device(x, fwd, adj)
    if atb is not None:
        _check_image(atb, "atb", like=x)
    taps = gram_taps(fwd, adj)
    if x.device.type == "cpu":
        return sepgram2d_plain(x, fwd, adj, atb)
    H, W = x.shape
    g = torch.empty_like(x)
    err = library().pct_sepgram2d(
        x.data_ptr(), 0 if atb is None else atb.data_ptr(), g.data_ptr(), H, W,
        taps.ctypes.data, fwd.rank, fwd.Ku, fwd.Kv, fwd.ou, fwd.ov, adj.ou, adj.ov,
        2.0, stream_of(x),
    )
    check(err, "sepgram2d")
    sepgram2d.launches += 1
    return g


sepgram2d.launches = 0
