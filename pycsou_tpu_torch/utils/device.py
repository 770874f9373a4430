"""Device handling and float32 precision.

The port runs on the CUDA card unless the caller asks for the CPU.  A
device comes, in this order, from an explicit ``device=`` argument, from
the tensors given (tensors on the CPU ask for the CPU), from the port's own
default set by :func:`set_default_device`, and otherwise is ``cuda``.  A
CUDA device on a machine without CUDA raises, naming ``device="cpu"``: the
port never moves work to the CPU on its own.  PyTorch's global default
device is not read.

:func:`settle_cpu_math` runs once when the package is imported (see there).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

__all__ = ["resolve_device", "set_default_device", "get_default_device", "as_tensor", "full_f32",
           "settle_cpu_math"]

_DEFAULT: Optional[torch.device] = None  # set_default_device; None means cuda


def set_default_device(device) -> None:
    """The device the port's entry points take when neither ``device=`` nor
    a tensor names one (``None`` restores ``cuda``).  The CPU tests call
    ``set_default_device("cpu")``."""
    global _DEFAULT
    _DEFAULT = None if device is None else torch.device(device)


def get_default_device() -> torch.device:
    """The device :func:`resolve_device` falls back to."""
    return torch.device("cuda") if _DEFAULT is None else _DEFAULT


def resolve_device(device=None, *sources) -> torch.device:
    """``device`` if given, else the device of the first tensor (or
    ``torch.device``) among ``sources``, else :func:`get_default_device`.
    Raises for a CUDA device when ``torch.cuda.is_available()`` is false."""
    if device is not None:
        dev = torch.device(device)
    else:
        found = (
            s.device if isinstance(s, torch.Tensor) else s
            for s in sources
            if isinstance(s, (torch.Tensor, torch.device))
        )
        dev = next(found, None) or get_default_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: torch.cuda.is_available() is False.  The port runs on the CUDA card "
            'unless asked for the CPU: pass device="cpu" (or CPU tensors), or call '
            'pycsou_tpu_torch.set_default_device("cpu")'
        )
    return dev


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (tensor, numpy array or scalar) as a ``dtype`` tensor on
    ``device`` (a copy when it has to move or convert)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=dtype, device=device)


def settle_cpu_math() -> None:
    """Calls ``sqrt``, ``log``, ``cos`` and ``abs``, the unary math of the
    plain versions, once on 8 elements of each float type, on one thread.

    On the CPU, ATen hands these ops to MKL's vector math library (VML),
    one chunk of the tensor to each OpenMP thread.  The first such call in
    a process can race MKL's choice of code path: one thread's chunk then
    comes out of a low-accuracy square root, far outside float32 rounding,
    while the rest and every later call are exact.  It shows in some fresh
    processes where threads have just run (JAX's interpret-mode kernels in
    a test worker); it does not with ``MKL_CBWR=COMPATIBLE``, one OpenMP
    thread, or a first call on one thread, which is what this is."""
    for dtype in (torch.float32, torch.float64):
        t = torch.full((8,), 2.0, dtype=dtype)
        for op in (torch.sqrt, torch.log, torch.cos, torch.abs):
            op(t)


def _precision_switch(backend):
    """``(owner, name, full-f32 value)`` of a backend's f32 switch: the
    per-operator ``fp32_precision`` of newer PyTorch, else the legacy
    ``allow_tf32``."""
    if backend is torch.backends.cudnn:
        op = getattr(backend, "conv", None)
    else:
        op = backend.matmul
    if op is not None and hasattr(op, "fp32_precision"):
        return op, "fp32_precision", "ieee"
    return (backend if backend is torch.backends.cudnn else backend.matmul), "allow_tf32", False


@contextlib.contextmanager
def full_f32():
    """Full IEEE f32 for cuDNN convolutions and matrix products inside the
    block; the caller's settings come back on exit, so nothing outside the
    block changes.  The plain versions of the kernels call ``F.conv2d`` and
    small matrix products, where TF32 (cuDNN's default for convolutions)
    would change the operator."""
    switches = [_precision_switch(torch.backends.cudnn), _precision_switch(torch.backends.cuda)]
    saved = [getattr(owner, name) for owner, name, _ in switches]
    for owner, name, value in switches:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for (owner, name, _), value in zip(switches, saved):
            setattr(owner, name, value)
