"""Base class of every operator, functional and solver of the port.

The JAX package registers each class as a pytree so that ``jit`` can trace
through it (``pycsou_tpu/_module.py``).  PyTorch runs eagerly, so here a
module is a plain Python object holding tensors and Python scalars as
attributes; :meth:`Module.replace` keeps the functional-update idiom.
"""
from __future__ import annotations

import copy
from typing import Any

__all__ = ["Module"]


class Module:
    """Plain attribute holder with a functional ``replace``."""

    def replace(self, **changes: Any):
        """Return a shallow copy with the given attributes replaced."""
        obj = copy.copy(self)
        for k, v in changes.items():
            if not hasattr(obj, k):
                raise AttributeError(f"{type(self).__name__} has no field {k!r}")
            setattr(obj, k, v)
        return obj

    def __repr__(self):
        parts = [
            f"{k}={v!r}"
            for k, v in vars(self).items()
            if not k.startswith("_") and isinstance(v, (bool, int, float, str, tuple))
        ]
        return f"{type(self).__name__}({', '.join(parts)})"
