"""Sharded solvers on a mesh of devices (counterpart of
``pycsou_tpu/parallel``): the mesh, the halo exchange (rows, and columns on
a 2-D mesh), the sharded operators of ``spatial.py``,
``DistributedTVDeconv2D``, ``BatchedDistributedTVDeconv2D`` and
``Spatial2DTVDeconv2D``."""
from pycsou_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d, mesh_shape_2d
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
)

__all__ = [
    "BatchedDistributedTVDeconv2D",
    "DistributedTVDeconv2D",
    "Mesh",
    "Spatial2DTVDeconv2D",
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
]
