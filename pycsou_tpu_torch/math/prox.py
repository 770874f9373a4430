"""Proximal maps and projections of the TV-deconvolution slice
(counterpart of ``pycsou_tpu/math/prox.py``; real tensors).  The l1-ball
projection, Lambert W and the other projections wait for ROADMAP Queue 1
item 11."""
from __future__ import annotations

import torch

__all__ = ["soft", "proj_linfty_ball", "proj_nonnegative_orthant"]


def soft(x, tau):
    """Soft-thresholding ``max(|x| - tau, 0) sign(x)``."""
    x = torch.as_tensor(x)
    return torch.clamp(x.abs() - tau, min=0.0) * torch.sign(x)


def proj_linfty_ball(x, radius):
    """Projection onto the l-infinity ball: elementwise clip."""
    return torch.clamp(torch.as_tensor(x), -radius, radius)


def proj_nonnegative_orthant(x):
    """Projection onto ``x >= 0``."""
    return torch.clamp(torch.as_tensor(x), min=0.0)
