"""Solver state across the two packages, as numpy arrays.

A JAX solver state (``pycsou_tpu``), with each entry turned into a numpy
array, becomes the port's state with :func:`state_from_numpy`, and back
with :func:`state_to_numpy`.  Both the fused TV layout (``x``, ``z0``,
``z1``, ``_stats``, ``it``, ``metric``, histories) and the generic PDS
layout (``x``, a stacked ``z``, ``_gstats``, ...) pass through unchanged:
the keys are the same in both packages.  The iteration counter ``it`` is a
device scalar in JAX and a Python int in the port.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pycsou_tpu_torch.utils.device import resolve_device

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """Port state on ``device`` from a dict of numpy arrays (or scalars)."""
    dev = resolve_device(device)
    out = {}
    for k, v in state.items():
        if k == "it":
            out[k] = int(np.asarray(v))
        else:
            out[k] = torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Dict of numpy arrays from a port state (``it`` as int32, the JAX
    package's type)."""
    out = {}
    for k, v in state.items():
        if k == "it":
            out[k] = np.asarray(v, dtype=np.int32)
        else:
            out[k] = v.detach().cpu().numpy()
    return out
