"""Mesh-sharded explicit operators (counterpart of
``pycsou_tpu/parallel/sharded.py``): the reference's stand-in for Dask-chunked
matrices and for the block operators whose ``n_jobs`` it never used.

* :class:`ShardedDenseOperator` keeps a dense matrix as blocks over a 1-D
  or 2-D mesh (``NamedSharding(mesh, PartitionSpec(row_axis,
  col_axis)).split``), each on its position's device.  ``apply`` and
  ``adjoint`` take and return whole tensors on the caller's device: each
  block contracts on its own device, and the partial results come to the
  caller's device, where those of one output block are added in mesh order
  (the reference's XLA-inserted ``psum``).  A row-sharded ``apply`` and a
  column-sharded ``adjoint`` add nothing.
* :class:`ShardedBlockDiagonalOperator` maps block i of x through operator
  i of a :func:`~pycsou_tpu_torch.opt.admm.stack_operators` holder on its
  mesh position's device, ``S / n`` blocks a position, with no sum.

On a mesh that spans processes each process holds the blocks of its own
positions only (``from_blocks`` takes only those, so no process builds
another's block), computes their parts, and gathers the other processes'
parts (``parallel.mesh.gather_positions``) before adding them in the same
order: every process gets the whole output, bit for bit that of the same
mesh driven by one process.

The products are ``torch.matmul`` in full f32 (``full_f32``): the
reference's ``DenseOperator`` is an XLA contraction, not a Pallas kernel.
A block operator that launches a kernel (a band ``Convolve2D``, K1)
launches it on its own device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.ops.basic import DenseOperator
from pycsou_tpu_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec, each, gather_positions, make_mesh
from pycsou_tpu_torch.utils.device import Remote, as_tensor, dtype_of, full_f32, resolve_device, same_device

__all__ = ["ShardedDenseOperator", "ShardedBlockDiagonalOperator"]


class ShardedDenseOperator(DenseOperator):
    """Dense operator whose matrix lives in blocks over a device mesh:
    ``row_axis`` and ``col_axis`` name the mesh axes its rows and columns
    are cut over (either may be None).  ``mat`` joins the blocks on the
    first local mesh device when it is read (``tosparse``, ``opnorm``).
    ``blocks`` has one entry a mesh position, a ``Remote`` for another
    process's.

    Example (a row-sharded matvec; the reference's Dask-explicit
    operator)::

        >>> import torch
        >>> from pycsou_tpu_torch.parallel import ShardedDenseOperator, make_mesh
        >>> A = ShardedDenseOperator(2.0 * torch.eye(8), mesh=make_mesh((4,), devices=["cpu"] * 4))
        >>> A(torch.ones(8)).tolist()
        [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]
        >>> len(A.blocks)
        4
    """

    def __init__(self, mat, mesh: Optional[Mesh] = None, row_axis: Optional[str] = "sp",
                 col_axis: Optional[str] = None, dtype=None):
        mesh = mesh if mesh is not None else make_mesh(axis_names=(row_axis or "sp",))
        dev = resolve_device(None, mat, mesh.local_device)
        mat = as_tensor(mat, dev, dtype_of(mat) if dtype is None else dtype)
        if mat.ndim != 2:
            raise ValueError("mat must be 2-D; use dim_shape/codim_shape for nd domains")
        sharding = NamedSharding(mesh, PartitionSpec(row_axis, col_axis))
        self._setup(sharding.split(mat), mesh, row_axis, col_axis, tuple(mat.shape))

    def _setup(self, blocks, mesh, row_axis, col_axis, shape):
        LinearOperator.__init__(self, (shape[1],), (shape[0],), dtype=blocks[0].dtype)
        self.mesh, self.row_axis, self.col_axis = mesh, row_axis, col_axis
        self.blocks = mesh.place(blocks)
        self._sharding = NamedSharding(mesh, PartitionSpec(row_axis, col_axis))
        # each block's (row block, column block), and the first position of
        # each: a block replicated over a mesh axis is used once
        idx = [self._sharding.block_index(p, 2) for p in range(mesh.size)]
        first = {}
        for p, ij in enumerate(idx):
            first.setdefault(ij, p)
        self._tiles = tuple((ij, p) for ij, p in first.items())
        self._n_r, self._n_c = self._sharding.parts(2)
        self._rb, self._cb = shape[0] // self._n_r, shape[1] // self._n_c

    @staticmethod
    def from_blocks(row_blocks: Sequence, mesh: Optional[Mesh] = None, row_axis: str = "sp",
                    dtype=None) -> "ShardedDenseOperator":
        """A row-sharded operator from one row block a position of this
        process (``mesh.local_positions``; every position on a mesh within
        one process), each put on its position's device directly: the whole
        matrix is never built, and on a mesh that spans processes no process
        builds another's block (the reference's Dask out-of-core
        assembly)."""
        mesh = mesh if mesh is not None else make_mesh(axis_names=(row_axis,))
        local = mesh.local_positions
        if len(row_blocks) != len(local):
            raise ValueError(f"need {len(local)} row blocks (this process's positions), got {len(row_blocks)}")
        if mesh.axis_size(row_axis) != mesh.size:
            raise ValueError(f"from_blocks cuts the rows over the whole mesh; {row_axis!r} has "
                             f"{mesh.axis_size(row_axis)} of its {mesh.size} positions")
        blocks = [as_tensor(b, mesh.devices[p], dtype_of(b) if dtype is None else dtype)
                  for b, p in zip(row_blocks, local)]
        if any(b.ndim != 2 or b.shape != blocks[0].shape for b in blocks):
            raise ValueError("row blocks must be equally sized 2-D arrays")
        op = object.__new__(ShardedDenseOperator)
        rows, cols = blocks[0].shape
        op._setup(blocks, mesh, row_axis, None, (rows * mesh.size, cols))
        return op

    @property
    def mat(self) -> torch.Tensor:
        """The whole matrix, joined on the first local mesh device (on a
        mesh that spans processes, on every process)."""
        return self._sharding.join(self.blocks)

    @property
    def device(self):
        return self.mesh.local_device

    def _contract(self, v, adjoint: bool):
        """``M v`` (or ``M^H v``) of the flat ``v``: each block's product on
        its own device, the other processes' products gathered, the parts
        of one output block added on ``v``'s device in mesh order."""
        out_n, in_b = (self._n_c, self._rb) if adjoint else (self._n_r, self._cb)

        def product(blk, k):
            vin = v[k * in_b : (k + 1) * in_b].to(blk.device, non_blocking=True)
            return (torch.conj(blk).T @ vin if adjoint else blk @ vin).to(v.device, non_blocking=True)

        # each tile's (output block, input block), and its product where this process holds it
        blocks_of = [(j, i) if adjoint else (i, j) for (i, j), _ in self._tiles]
        with full_f32():
            prods = each(product, [self.blocks[p] for _, p in self._tiles], [k for _, k in blocks_of])
        parts = [None] * out_n
        for (o, _), part in zip(blocks_of, gather_positions(prods)):
            parts[o] = part if parts[o] is None else parts[o] + part
        return torch.cat(parts) if out_n > 1 else parts[0]

    def apply(self, x):
        x = torch.as_tensor(x)
        return self._contract(x.reshape(-1).to(self.dtype), adjoint=False).reshape(self.codim_shape)

    def adjoint(self, y):
        y = torch.as_tensor(y)
        return self._contract(y.reshape(-1).to(self.dtype), adjoint=True).reshape(self.dim_shape)


class ShardedBlockDiagonalOperator(LinearOperator):
    """Block-diagonal operator whose S same-family blocks are spread over a
    mesh axis: ``apply`` maps block i of ``x`` (shape ``(S, *dim_shape)``)
    through ``ops[i]`` on its mesh position's device, with no communication
    between blocks (the reference's ``BlockDiagonal`` ``n_jobs`` promise).

    ``ops``: the :func:`~pycsou_tpu_torch.opt.admm.stack_operators` holder
    of the S operators, each built on its position's device (or holding no
    tensor); ``n_blocks``: S, a multiple of the mesh's size.  On a mesh
    that spans processes each process gives all S operators and applies
    those of its own positions; the other blocks of the output are
    gathered, so every process holds it whole."""

    def __init__(self, ops, n_blocks: int, mesh: Optional[Mesh] = None, axis_name: str = "dp"):
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(axis_name,))
        self.axis_name = self.mesh.axis_names[0]
        if n_blocks % self.mesh.size:
            raise ValueError("n_blocks must divide over the mesh")
        ops = tuple(ops)
        if len(ops) != n_blocks:
            raise ValueError(f"{len(ops)} operators for n_blocks={n_blocks}")
        self.S = int(n_blocks)
        per = self.S // self.mesh.size
        self._devices = tuple(self.mesh.devices[i // per] for i in range(self.S))
        self._ranks = tuple(self.mesh.ranks[i // per] for i in range(self.S))
        for i, (op, d) in enumerate(zip(ops, self._devices)):
            if self._ranks[i] != self.mesh.process_index:
                continue  # another process's position: its device is a label here
            if op.device is not None and not same_device(op.device, d):
                raise ValueError(f"block operator {i} lives on {op.device}; its mesh position's device is {d}")
        t = ops[0]
        super().__init__((self.S,) + t.dim_shape, (self.S,) + t.codim_shape,
                         lipschitz=max(op.lipschitz for op in ops), dtype=t.dtype)
        self.ops = ops

    @property
    def device(self):
        return self.mesh.local_device

    @property
    def batchable(self) -> bool:
        return all(op.batchable for op in self.ops)

    def _map(self, fn, x):
        x = torch.as_tensor(x)
        me = self.mesh.process_index
        out = [fn(op, x[i].to(d, non_blocking=True)).to(x.device, non_blocking=True) if r == me else Remote(r)
               for i, (op, d, r) in enumerate(zip(self.ops, self._devices, self._ranks))]
        return torch.stack(gather_positions(out))

    def apply(self, x):
        return self._map(lambda op, b: op.apply(b), x)

    def adjoint(self, y):
        return self._map(lambda op, b: op.adjoint(b), y)
