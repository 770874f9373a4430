"""Row-sharded solvers on a mesh of devices (counterpart of
``pycsou_tpu/parallel``): the mesh, the row-halo exchange and
``DistributedTVDeconv2D``."""
from pycsou_tpu_torch.parallel.mesh import Mesh, make_mesh
from pycsou_tpu_torch.parallel.solvers import DistributedTVDeconv2D
from pycsou_tpu_torch.parallel.spatial import halo_extend, halo_from_next, halo_from_prev, halos

__all__ = ["DistributedTVDeconv2D", "Mesh", "halo_extend", "halo_from_next", "halo_from_prev", "halos", "make_mesh"]
