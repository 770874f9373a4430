"""Plain reference of TV inpainting: ``A`` the gather of the kept pixels
(row-major order), so ``A^H A`` is the keep mask and ``A^H y`` the
observation set back onto a zero image; ``||A|| = 1``, ``beta = 2``.  It
imports nothing of the program and takes the mask and ``y`` as the
benchmark made them."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location("perfbench_reference_condat_vu",
                                               Path(__file__).with_name("condat_vu.py"))
cv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cv)


class Problem:
    def __init__(self, inputs, device, dtype=torch.float64):
        keep = inputs["mask"].to(device=device, dtype=torch.bool)
        self.device, self.shape = torch.device(device), tuple(keep.shape)
        self.m = keep.to(dtype)
        atb = torch.zeros(keep.numel(), dtype=torch.float64, device=device)
        atb[keep.reshape(-1)] = inputs["y"].to(device=device, dtype=torch.float64)
        self.atb = atb.reshape(self.shape).to(dtype)
        self.beta = 2.0 if bool(keep.any()) else 0.0

    def grad(self, x, dtype):
        return 2 * (self.m * x - self.atb)


def solve(inputs, cfg: dict, device, **kw):
    dtype = kw.pop("dtype", torch.float64)
    problem = Problem(inputs, device, dtype)
    return cv.solve(problem, lam=float(cfg["lam"]), rho=float(cfg["rho"]), nonneg=bool(cfg["nonneg"]),
                    dtype=dtype, **kw)
