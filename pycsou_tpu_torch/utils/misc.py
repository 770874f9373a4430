"""Miscellaneous utilities: the peaks test surface and range-broadcasting
of matrix shapes (counterpart of ``pycsou_tpu/utils/misc.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["peaks", "is_range_broadcastable", "range_broadcast_shape"]


def peaks(x, y):
    """MATLAB's peaks test surface, elementwise on tensors (arrays and
    scalars are taken as float32 CPU tensors).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.utils.misc import peaks
        >>> round(float(peaks(torch.tensor(0.0, device=dev), torch.tensor(0.0, device=dev))), 4)
        0.981
    """
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float32)
    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(y, dtype=torch.float32)
    return (
        3 * (1 - x) ** 2 * torch.exp(-(x**2) - (y + 1) ** 2)
        - 10 * (x / 5 - x**3 - y**5) * torch.exp(-(x**2) - y**2)
        - 1 / 3 * torch.exp(-((x + 1) ** 2) - y**2)
    )


def is_range_broadcastable(shape1: Tuple[int, int], shape2: Tuple[int, int]) -> bool:
    """Matrix shapes ``(m, n)``: the domains agree and the ranges agree or
    one is 1."""
    if shape1[1] != shape2[1]:
        return False
    return shape1[0] == shape2[0] or 1 in (shape1[0], shape2[0])


def range_broadcast_shape(shape1: Tuple[int, int], shape2: Tuple[int, int]) -> Tuple[int, int]:
    """The broadcast shape of two range-broadcastable shapes."""
    if not is_range_broadcastable(shape1, shape2):
        raise ValueError(f"shapes {shape1} and {shape2} are not range-broadcastable")
    return (max(shape1[0], shape2[0]), shape1[1])
