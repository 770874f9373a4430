"""Shape utilities for operators on nd-array domains
(counterpart of ``pycsou_tpu/utils/shapes.py``)."""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

ShapeLike = Union[int, Sequence[int], Tuple[int, ...]]


def as_shape(s: ShapeLike) -> Tuple[int, ...]:
    """Canonicalise an int / sequence into a shape tuple. ``()`` = scalar."""
    if s is None:
        return ()
    if isinstance(s, int):
        return (int(s),)
    return tuple(int(d) for d in s)


def size_of(shape: Tuple[int, ...]) -> int:
    return int(math.prod(shape)) if shape else 1


def split_flat(v, shapes: Sequence[Tuple[int, ...]]) -> list:
    """Cut the flat vector ``v`` into consecutive blocks of the given
    shapes."""
    out, start = [], 0
    for shape in shapes:
        size = size_of(shape)
        out.append(v[start : start + size].reshape(shape))
        start += size
    return out
