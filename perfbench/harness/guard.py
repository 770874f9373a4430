"""What a run may load and which program it measures.

The JAX package is the port's reference and is never measured: a run that
holds ``jax``, ``jaxlib``, ``flax`` or ``pycsou_tpu`` in ``sys.modules``
prints no result.  Names are compared by their whole top-level part
(before the first dot), since the port's own name begins with the JAX
package's."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "pycsou_tpu")
PROGRAM = "pycsou_tpu_torch"


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def import_program(root: Path):
    """The port, imported from the checkout at ``root``; raises when it is
    missing there or another copy of it is loaded."""
    root = Path(root).resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    mod = importlib.import_module(PROGRAM)
    where = Path(mod.__file__).resolve()
    if root not in where.parents:
        raise ImportError(f"{PROGRAM} was loaded from {where}, outside the checkout {root}")
    return mod
