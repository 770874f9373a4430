"""Operator stacking: vertical and horizontal stacks, block-diagonal and
block operators, and stacks of (differentiable) maps (counterpart of
``pycsou_tpu/ops/stack.py``).

A stack's output keeps the natural layout ``(k, *codim_shape)`` when every
block has the same codomain, and is the flat concatenation of the blocks'
outputs otherwise (``[Masking; DCTOperator]`` is such a stack).  The
closed-form Lipschitz bound ``sqrt(sum L_i^2)`` is loose; a stack's
``compute_lipschitz_cst()`` replaces it by the power iteration's estimate.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.core.map import DifferentiableMap, Map
from pycsou_tpu_torch.utils.shapes import split_flat

__all__ = [
    "LinOpVStack",
    "LinOpHStack",
    "LinOpStack",
    "BlockDiagonalOperator",
    "BlockOperator",
    "MapVStack",
    "MapHStack",
    "MapStack",
    "DiffMapVStack",
    "DiffMapHStack",
    "DiffMapStack",
]


def _stack_lip(ops) -> float:
    return math.sqrt(sum(o.lipschitz**2 for o in ops))


def _first_device(ops):
    return next((o.device for o in ops if o.device is not None), None)


def _sum(terms):
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


class LinOpVStack(LinearOperator):
    """``[A1; A2; ...]``: a shared domain, stacked ranges; the adjoint sums
    ``A_i^H y_i``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import IdentityOperator
        >>> from pycsou_tpu_torch.ops.stack import LinOpVStack
        >>> V = LinOpVStack([IdentityOperator((2,)), 2.0 * IdentityOperator((2,))])
        >>> V(torch.tensor([1.0, 2.0], device=dev)).tolist()
        [[1.0, 2.0], [2.0, 4.0]]
        >>> V.adjoint(torch.ones(2, 2, device=dev)).tolist()   # sum of block adjoints
        [3.0, 3.0]
    """

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        dim_shape = ops[0].dim_shape
        if any(o.dim_shape != dim_shape for o in ops):
            raise ValueError("all stacked operators must share the domain")
        uniform = all(o.codim_shape == ops[0].codim_shape for o in ops)
        codim = (len(ops),) + ops[0].codim_shape if uniform else (sum(o.codim for o in ops),)
        super().__init__(dim_shape, codim, lipschitz=_stack_lip(ops), dtype=ops[0].dtype)
        self.ops = ops
        self.uniform = uniform

    @property
    def device(self):
        return _first_device(self.ops)

    def apply(self, x):
        ys = [o.apply(x) for o in self.ops]
        if self.uniform:
            return torch.stack(ys, dim=0)
        return torch.cat([y.reshape(-1) for y in ys])

    def adjoint(self, y):
        y = torch.as_tensor(y)
        if self.uniform:
            return _sum(o.adjoint(y[i]) for i, o in enumerate(self.ops))
        blocks = split_flat(y, [o.codim_shape for o in self.ops])
        return _sum(o.adjoint(b) for o, b in zip(self.ops, blocks))


class LinOpHStack(LinearOperator):
    """``[A1, A2, ...]``: a split domain, a shared range; the forward sums
    ``A_i x_i``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import IdentityOperator
        >>> from pycsou_tpu_torch.ops.stack import LinOpHStack
        >>> Hs = LinOpHStack([IdentityOperator((2,)), IdentityOperator((2,))])
        >>> Hs(torch.tensor([[1.0, 2.0], [10.0, 20.0]], device=dev)).tolist()
        [11.0, 22.0]
    """

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        codim_shape = ops[0].codim_shape
        if any(o.codim_shape != codim_shape for o in ops):
            raise ValueError("all stacked operators must share the range")
        uniform = all(o.dim_shape == ops[0].dim_shape for o in ops)
        dim = (len(ops),) + ops[0].dim_shape if uniform else (sum(o.dim for o in ops),)
        super().__init__(dim, codim_shape, lipschitz=_stack_lip(ops), dtype=ops[0].dtype)
        self.ops = ops
        self.uniform = uniform

    @property
    def device(self):
        return _first_device(self.ops)

    def apply(self, x):
        if self.uniform:
            return _sum(o.apply(x[i]) for i, o in enumerate(self.ops))
        blocks = split_flat(x, [o.dim_shape for o in self.ops])
        return _sum(o.apply(b) for o, b in zip(self.ops, blocks))

    def adjoint(self, y):
        y = torch.as_tensor(y)
        xs = [o.adjoint(y) for o in self.ops]
        if self.uniform:
            return torch.stack(xs, dim=0)
        return torch.cat([x.reshape(-1) for x in xs])


def LinOpStack(ops: Sequence[LinearOperator], axis: int):
    """``axis=0`` vertical, ``axis=1`` horizontal."""
    if axis == 0:
        return LinOpVStack(ops)
    if axis == 1:
        return LinOpHStack(ops)
    raise ValueError("axis must be 0 or 1")


class BlockDiagonalOperator(LinearOperator):
    """``diag(A1, ..., Ak)`` over a flat-concatenated domain and range;
    ``L = max L_i``.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import DiagonalOperator
        >>> from pycsou_tpu_torch.ops.stack import BlockDiagonalOperator
        >>> B = BlockDiagonalOperator([DiagonalOperator([1.0, 2.0]), DiagonalOperator([-1.0])])
        >>> B(torch.tensor([1.0, 1.0, 1.0], device=dev)).tolist()
        [1.0, 2.0, -1.0]
    """

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        dim = sum(o.dim for o in ops)
        codim = sum(o.codim for o in ops)
        super().__init__((dim,), (codim,), lipschitz=max(o.lipschitz for o in ops), dtype=ops[0].dtype)
        self.ops = ops

    @property
    def device(self):
        return _first_device(self.ops)

    def apply(self, x):
        blocks = split_flat(x, [o.dim_shape for o in self.ops])
        return torch.cat([o.apply(b).reshape(-1) for o, b in zip(self.ops, blocks)])

    def adjoint(self, y):
        blocks = split_flat(torch.as_tensor(y), [o.codim_shape for o in self.ops])
        return torch.cat([o.adjoint(b).reshape(-1) for o, b in zip(self.ops, blocks)])


class BlockOperator(LinearOperator):
    """``[[A11, A12], [A21, A22], ...]``: ``y_i = sum_j A_ij x_j`` over
    flat-concatenated domain and range; ``L <= sqrt(sum L_ij^2)``."""

    def __init__(self, grid: Sequence[Sequence[LinearOperator]]):
        grid = tuple(tuple(row) for row in grid)
        ncols = len(grid[0])
        if any(len(row) != ncols for row in grid):
            raise ValueError("ragged block grid")
        for row in grid:
            if any(o.codim_shape != row[0].codim_shape for o in row):
                raise ValueError("blocks in a row must share the range shape")
        for j in range(ncols):
            if any(grid[i][j].dim_shape != grid[0][j].dim_shape for i in range(len(grid))):
                raise ValueError("blocks in a column must share the domain shape")
        dim = sum(grid[0][j].dim for j in range(ncols))
        codim = sum(row[0].codim for row in grid)
        lip = math.sqrt(sum(o.lipschitz**2 for row in grid for o in row))
        super().__init__((dim,), (codim,), lipschitz=lip, dtype=grid[0][0].dtype)
        self.grid = grid

    @property
    def device(self):
        return _first_device([o for row in self.grid for o in row])

    def apply(self, x):
        xs = split_flat(x, [o.dim_shape for o in self.grid[0]])
        return torch.cat([_sum(o.apply(xj) for o, xj in zip(row, xs)).reshape(-1) for row in self.grid])

    def adjoint(self, y):
        ys = split_flat(torch.as_tensor(y), [row[0].codim_shape for row in self.grid])
        cols = range(len(self.grid[0]))
        return torch.cat([_sum(row[j].adjoint(yi) for row, yi in zip(self.grid, ys)).reshape(-1) for j in cols])


class MapVStack(Map):
    """Vertical stack of (possibly nonlinear) maps over a shared domain.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops.basic import IdentityOperator
        >>> from pycsou_tpu_torch.ops.stack import MapVStack
        >>> V = MapVStack([IdentityOperator((2,)), -1.0 * IdentityOperator((2,))])
        >>> V(torch.tensor([1.0, 2.0], device=dev)).tolist()
        [[1.0, 2.0], [-1.0, -2.0]]
    """

    def __init__(self, maps: Sequence[Map]):
        maps = tuple(maps)
        dim_shape = maps[0].dim_shape
        if any(m.dim_shape != dim_shape for m in maps):
            raise ValueError("all stacked maps must share the domain")
        uniform = all(m.codim_shape == maps[0].codim_shape for m in maps)
        codim = (len(maps),) + maps[0].codim_shape if uniform else (sum(max(m.codim, 1) for m in maps),)
        super().__init__(dim_shape, codim, lipschitz=_stack_lip(maps))
        self.maps = maps
        self.uniform = uniform

    @property
    def device(self):
        return _first_device(self.maps)

    def apply(self, x):
        ys = [m.apply(x) for m in self.maps]
        if self.uniform:
            return torch.stack(ys, dim=0)
        return torch.cat([torch.atleast_1d(y).reshape(-1) for y in ys])


class MapHStack(Map):
    """Horizontal stack: split the input, sum the outputs."""

    def __init__(self, maps: Sequence[Map]):
        maps = tuple(maps)
        codim_shape = maps[0].codim_shape
        if any(m.codim_shape != codim_shape for m in maps):
            raise ValueError("all stacked maps must share the range")
        uniform = all(m.dim_shape == maps[0].dim_shape for m in maps)
        dim = (len(maps),) + maps[0].dim_shape if uniform else (sum(m.dim for m in maps),)
        super().__init__(dim, codim_shape, lipschitz=_stack_lip(maps))
        self.maps = maps
        self.uniform = uniform

    @property
    def device(self):
        return _first_device(self.maps)

    def _blocks(self, x):
        if self.uniform:
            return [x[i] for i in range(len(self.maps))]
        return split_flat(x, [m.dim_shape for m in self.maps])

    def apply(self, x):
        return _sum(m.apply(b) for m, b in zip(self.maps, self._blocks(x)))


def MapStack(maps: Sequence[Map], axis: int):
    """``axis=0`` vertical, ``axis=1`` horizontal."""
    if axis == 0:
        return MapVStack(maps)
    if axis == 1:
        return MapHStack(maps)
    raise ValueError("axis must be 0 or 1")


class DiffMapVStack(MapVStack, DifferentiableMap):
    """Vertical stack of differentiable maps: ``beta <= sqrt(sum beta_i^2)``;
    ``jacobianT`` is the horizontal stack of the blocks' ``J_i^T``."""

    def __init__(self, maps: Sequence[DifferentiableMap]):
        MapVStack.__init__(self, maps)
        self._diff_lipschitz = math.sqrt(sum(m.diff_lipschitz**2 for m in self.maps))

    def jacobianT(self, x):
        x = torch.as_tensor(x)
        return LinOpHStack([_as_linop(m.jacobianT(x)) for m in self.maps])


class DiffMapHStack(MapHStack, DifferentiableMap):
    """Horizontal stack of differentiable maps: ``beta <= max beta_i``;
    ``jacobianT`` is the vertical stack of the blocks' ``J_i^T``."""

    def __init__(self, maps: Sequence[DifferentiableMap]):
        MapHStack.__init__(self, maps)
        self._diff_lipschitz = max(m.diff_lipschitz for m in self.maps)

    def jacobianT(self, x):
        blocks = self._blocks(torch.as_tensor(x))
        return LinOpVStack([_as_linop(m.jacobianT(b)) for m, b in zip(self.maps, blocks)])


def _as_linop(jac):
    """A functional's gradient tensor ``g`` as the operator ``alpha -> alpha
    g`` (scalar domain), so Jacobian stacks stay operators."""
    if isinstance(jac, LinearOperator):
        return jac
    from pycsou_tpu_torch.func.base import ExplicitLinearFunctional

    return ExplicitLinearFunctional(jac).H


def DiffMapStack(maps: Sequence[DifferentiableMap], axis: int):
    """``axis=0`` vertical, ``axis=1`` horizontal."""
    if axis == 0:
        return DiffMapVStack(maps)
    if axis == 1:
        return DiffMapHStack(maps)
    raise ValueError("axis must be 0 or 1")
