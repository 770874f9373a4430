"""Plain reference of TV deconvolution: ``A`` the 'same', zero-boundary
2-D convolution by the PSF, ``y[p] = sum_k h[k] x[p + m//2 - k]``, applied
through a zero-padded FFT grid of at least ``n + m - 1`` points a side (the
full linear convolution, cropped), and its adjoint by the conjugate
transfer.  ``||A|| <= max |DFT(h)|`` on that grid; ``beta = 2 ||A||^2``.
It imports nothing of the program and takes the PSF and ``y`` as the
benchmark made them."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location("perfbench_reference_condat_vu",
                                               Path(__file__).with_name("condat_vu.py"))
cv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cv)


def fast_len(n: int) -> int:
    """The least ``2^a 3^b >= n``."""
    best = 1 << max(0, (n - 1).bit_length())
    p3 = 1
    while p3 < n:
        m = p3
        while m < n:
            m *= 2
        best = min(best, m)
        p3 *= 3
    return best


class Problem:
    def __init__(self, inputs, device, dtype=torch.float64):
        y = inputs["y"].to(device)
        h = torch.as_tensor(inputs["psf"]).to(device=device, dtype=torch.float64)
        self.device, self.shape = torch.device(device), tuple(y.shape)
        self.m = tuple(h.shape)
        self.grid = tuple(fast_len(n + m - 1) for n, m in zip(self.shape, self.m))
        self.off = tuple(m // 2 for m in self.m)
        ft = cv.fft_dtype(dtype)
        hp = torch.zeros(self.grid, dtype=torch.float64, device=device)
        hp[: self.m[0], : self.m[1]] = h
        H = torch.fft.rfft2(hp)
        self.beta = 2.0 * float(torch.max(torch.abs(H))) ** 2
        self.H = H.to(torch.complex128 if ft == torch.float64 else torch.complex64)
        self.ft = ft
        self.atb = self.adjoint(y.to(ft)).to(dtype)

    def apply(self, x):
        (n0, n1), (o0, o1) = self.shape, self.off
        full = torch.fft.irfft2(torch.fft.rfft2(x.to(self.ft), s=self.grid) * self.H, s=self.grid)
        return full[o0:o0 + n0, o1:o1 + n1]

    def adjoint(self, r):
        (n0, n1), (o0, o1) = self.shape, self.off
        g0, g1 = self.grid
        rp = torch.nn.functional.pad(r.to(self.ft), (o1, g1 - n1 - o1, o0, g0 - n0 - o0))
        full = torch.fft.irfft2(torch.fft.rfft2(rp) * torch.conj(self.H), s=self.grid)
        return full[:n0, :n1]

    def grad(self, x, dtype):
        ax = self.apply(x).to(dtype)
        return 2 * (self.adjoint(ax).to(dtype) - self.atb)


def solve(inputs, cfg: dict, device, **kw):
    dtype = kw.pop("dtype", torch.float64)
    problem = Problem(inputs, device, dtype)
    return cv.solve(problem, lam=float(cfg["lam"]), rho=float(cfg["rho"]), nonneg=bool(cfg["nonneg"]),
                    dtype=dtype, **kw)
