"""Explicit device handling and float32 precision.

The port never chooses between CPU and GPU on the user's behalf: a device
comes from an explicit ``device=`` argument or from the tensors given, and
otherwise is PyTorch's own default device.  A CUDA request on a machine
without CUDA raises.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "full_f32"]


def resolve_device(device=None, *sources) -> torch.device:
    """``device`` if given, else the first tensor's device or
    ``torch.device`` among ``sources``, else
    ``torch.get_default_device()``.  Raises for CUDA when
    ``torch.cuda.is_available()`` is false."""
    if device is not None:
        dev = torch.device(device)
    else:
        found = (
            s.device if isinstance(s, torch.Tensor) else s
            for s in sources
            if isinstance(s, (torch.Tensor, torch.device))
        )
        dev = next(found, torch.get_default_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested, but torch.cuda.is_available() is False")
    return dev


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (tensor, numpy array or scalar) as a ``dtype`` tensor on
    ``device`` (a copy when it has to move or convert)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=dtype, device=device)


@contextlib.contextmanager
def full_f32():
    """Full IEEE f32 for cuDNN convolutions inside the block; the caller's
    setting comes back on exit, so nothing outside the block changes.  The
    plain versions of the kernels call ``F.conv2d``, where TF32 (cuDNN's
    default for convolutions) would change the operator.  Newer PyTorch has
    the per-operator ``cudnn.conv.fp32_precision`` switch; older PyTorch
    only the legacy ``cudnn.allow_tf32``."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        owner, name, value = conv, "fp32_precision", "ieee"
    else:
        owner, name, value = torch.backends.cudnn, "allow_tf32", False
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)
