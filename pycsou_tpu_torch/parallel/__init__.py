"""Sharded solvers and operators on a mesh of devices (counterpart of
``pycsou_tpu/parallel``): the mesh and its shardings, ``distributed_init``
and ``psum``, the halo exchange (rows, and columns on a 2-D mesh), the
sharded operators of ``spatial.py``, the sharded dense and block-diagonal
operators of ``sharded.py``, the pencil FFT of ``fft.py``,
``DistributedTVDeconv2D``, ``BatchedDistributedTVDeconv2D`` and
``Spatial2DTVDeconv2D``."""
from pycsou_tpu_torch.parallel.fft import PencilCircularConv2D, pencil_cols, pencil_irfft2, pencil_rfft2
from pycsou_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    distributed_init,
    make_mesh,
    make_mesh_2d,
    mesh_shape_2d,
    psum,
    replicated,
    shard_along,
)
from pycsou_tpu_torch.parallel.sharded import ShardedBlockDiagonalOperator, ShardedDenseOperator
from pycsou_tpu_torch.parallel.solvers import BatchedDistributedTVDeconv2D, DistributedTVDeconv2D, Spatial2DTVDeconv2D
from pycsou_tpu_torch.parallel.spatial import (
    halo_extend,
    halo_extend_2d,
    halo_from_next,
    halo_from_next_cols,
    halo_from_prev,
    halo_from_prev_cols,
    halos,
    halos_2d,
    lane_extend,
    pdot,
    pnorm,
    sharded_conv2d,
    sharded_conv2d_adjoint,
    sharded_fdiff_rows,
    sharded_fdiff_rows_adjoint,
    sharded_grad2d,
    sharded_grad2d_adjoint,
)

__all__ = [
    "BatchedDistributedTVDeconv2D",
    "DistributedTVDeconv2D",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "PencilCircularConv2D",
    "ShardedBlockDiagonalOperator",
    "ShardedDenseOperator",
    "Spatial2DTVDeconv2D",
    "distributed_init",
    "halo_extend",
    "halo_extend_2d",
    "halo_from_next",
    "halo_from_next_cols",
    "halo_from_prev",
    "halo_from_prev_cols",
    "halos",
    "halos_2d",
    "lane_extend",
    "make_mesh",
    "make_mesh_2d",
    "mesh_shape_2d",
    "pdot",
    "pencil_cols",
    "pencil_irfft2",
    "pencil_rfft2",
    "pnorm",
    "psum",
    "replicated",
    "shard_along",
    "sharded_conv2d",
    "sharded_conv2d_adjoint",
    "sharded_fdiff_rows",
    "sharded_fdiff_rows_adjoint",
    "sharded_grad2d",
    "sharded_grad2d_adjoint",
]
