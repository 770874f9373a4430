"""Device meshes and shardings (counterpart of ``pycsou_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of torch devices with named axes, driven by one
process, as the reference's ``jax.sharding.Mesh`` is under ``shard_map``: a
sharded solver keeps one block per mesh position on that position's device
and runs each block's kernels in mesh order.  A device may appear more than
once, so a mesh of four shards can live on one card
(``make_mesh((4,), devices=[torch.device("cuda", 0)] * 4)``); the CPU tests
use ``devices=["cpu"] * n``.  :func:`make_mesh_2d` gives the reference's
default ``(sp0, sp1)`` shape for ``Spatial2DTVDeconv2D``.

A :class:`NamedSharding` pairs a mesh with a :class:`PartitionSpec` (one
mesh-axis name, or None, per array axis) and cuts a whole tensor into the
blocks of the mesh's positions (:meth:`NamedSharding.split`) or joins them
(:meth:`NamedSharding.join`); :func:`replicated` and :func:`shard_along`
build the reference's two common ones.  They describe the ``x=`` of
``solver.with_shardings`` and the blocks of ``parallel/sharded.py``.

After :func:`distributed_init` (``torch.distributed`` over TCP: ``nccl``
where CUDA is present, else ``gloo``), :func:`make_mesh` spans every
process: ``world_size`` times the local devices, each position recording
its process's rank.  :func:`psum` adds the local blocks, then all-reduces
across the processes.  The sharded solvers and operators do not run on
such a mesh yet: each raises ``NotImplementedError`` (ROADMAP Queue 1 item
8) rather than run only the local shards.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch

__all__ = [
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "distributed_init",
    "make_mesh",
    "make_mesh_2d",
    "mesh_shape_2d",
    "psum",
    "replicated",
    "require_local",
    "shard_along",
]


def _joined() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    """This process's rank in ``torch.distributed`` (0 when not initialised)."""
    return torch.distributed.get_rank() if _joined() else 0


def _world() -> int:
    """The number of processes in ``torch.distributed`` (1 when not initialised)."""
    return torch.distributed.get_world_size() if _joined() else 1


def _cuda_devices() -> list:
    """Every visible CUDA device once; without CUDA, ``RuntimeError``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: torch.cuda.is_available() is False; pass devices= (for example "
            '["cpu"] * n, or [torch.device("cuda", 0)] * n for n shards on one card)'
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """``devices``: a flat tuple of ``torch.device`` in row-major mesh order;
    ``shape``: the mesh's shape (default: one axis over all the devices);
    ``axis_names``: one name per axis; ``ranks``: the process rank of each
    position (default: this process's, for all of them).
    ``process_index`` is this process's rank and ``local_positions`` the
    positions it drives."""

    def __init__(self, devices, axis_names: Sequence[str], shape: Optional[Sequence[int]] = None,
                 ranks: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = (len(self.devices),) if shape is None else tuple(int(s) for s in shape)
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"a mesh of shape {self.shape} needs {math.prod(self.shape)} devices, "
                             f"got {len(self.devices)}")
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.shape} needs {len(self.shape)} axis names, "
                             f"got {self.axis_names}")
        self.process_index = _rank()
        self.ranks = (self.process_index,) * self.size if ranks is None else tuple(int(r) for r in ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"{len(self.ranks)} ranks for a mesh of {self.size} positions")
        self.local_positions = tuple(i for i, r in enumerate(self.ranks) if r == self.process_index)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        """Whether the positions belong to more than one process."""
        return len(set(self.ranks)) > 1

    def axis_size(self, name: str) -> int:
        """The number of positions along the axis ``name``."""
        if name not in self.axis_names:
            raise ValueError(f"mesh axes are {self.axis_names}; no axis {name!r}")
        return self.shape[self.axis_names.index(name)]

    def coords(self, position: int) -> tuple:
        """The mesh coordinates of the flat (row-major) ``position``."""
        out = []
        for s in reversed(self.shape):
            position, c = divmod(position, s)
            out.append(c)
        return tuple(reversed(out))

    def axis_devices(self, name: str) -> tuple:
        """The devices along the axis ``name``, every other coordinate 0."""
        k = self.axis_names.index(name)
        return tuple(d for p, d in enumerate(self.devices)
                     if all(c == 0 for j, c in enumerate(self.coords(p)) if j != k))

    def __repr__(self):
        procs = f", ranks={self.ranks}" if self.spans_processes else ""
        return f"Mesh(shape={self.shape}, axis_names={self.axis_names}, devices={self.devices}{procs})"


def require_local(mesh: Mesh, what: str) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` spans processes: the
    sharded solvers and operators drive every shard from one process."""
    if mesh.spans_processes:
        raise NotImplementedError(
            f"{what} on a mesh that spans {len(set(mesh.ranks))} processes: each process would drive "
            "its own shards with halos and sums through torch.distributed, which is not ported yet "
            "(ROADMAP Queue 1 item 8)"
        )


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("sp",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device, each
    once), the first ``prod(shape)`` of them in order, of shape ``shape``
    (default: one axis over all of them).

        >>> make_mesh((4,), devices=["cpu"] * 4).shape
        (4,)

    Without CUDA and without ``devices`` it raises: pass ``devices=`` (for
    example ``["cpu"] * n``).  It never repeats a device on its own; a mesh
    of several shards on one card names that card several times.  After
    :func:`distributed_init` of several processes ``devices`` are each
    process's local devices (the same list in every process), and the mesh
    runs over ``world_size`` times them, rank by rank."""
    devices = _cuda_devices() if devices is None else [torch.device(d) for d in devices]
    world = _world()
    ranks = [r for r in range(world) for _ in devices]
    devices = devices * world
    shape = (len(devices),) if shape is None else tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > len(devices) or n < 1:
        raise ValueError(f"mesh of shape {shape} needs {n} devices, {len(devices)} given")
    return Mesh(devices[:n], axis_names, shape, ranks=ranks[:n])


def mesh_shape_2d(n: int) -> tuple:
    """The reference's default 2-D shape for ``n`` devices
    (``Spatial2DTVDeconv2D``'s default mesh): ``n0 = isqrt(n)``, lowered
    until it divides ``n``, and ``n1 = n // n0``.

        >>> mesh_shape_2d(8)
        (2, 4)
    """
    n0 = math.isqrt(n)
    while n % n0:
        n0 -= 1
    return n0, n // n0


def make_mesh_2d(axis_names: Sequence[str] = ("sp0", "sp1"), devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D mesh of :func:`mesh_shape_2d` over ``devices`` (default, as
    :func:`make_mesh`: every visible CUDA device once; ``(1, 1)`` on one
    card; after :func:`distributed_init`, over every process's)."""
    local = _cuda_devices() if devices is None else list(devices)
    return make_mesh(mesh_shape_2d(len(local) * _world()), axis_names, local)


# -- shardings ---------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per array axis: the name of the mesh axis it is cut over, a
    tuple of names (cut over their product, row-major), or None (not cut).
    Axes past the spec's length are not cut.

        >>> PartitionSpec("sp", None)
        PartitionSpec('sp', None)
    """

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}" if len(self) != 1 else f"PartitionSpec({self[0]!r})"


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: the blocks a whole tensor is cut
    into, one a mesh position, each on its position's device."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        named = [a for e in self.spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
        for a in named:
            mesh.axis_size(a)  # raises for an axis the mesh lacks
        if len(set(named)) != len(named):
            raise ValueError(f"{self.spec} names a mesh axis twice")

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _axes(self, entry) -> tuple:
        return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)

    def parts(self, ndim: int) -> tuple:
        """The number of blocks each of ``ndim`` array axes is cut into."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has {len(self.spec)} entries for an array of {ndim} axes")
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(self.mesh.axis_size(a) for a in self._axes(e)) for e in spec)

    def check_shape(self, shape) -> None:
        """``ValueError`` when an axis does not divide over its mesh axes."""
        for n, (size, k) in enumerate(zip(shape, self.parts(len(shape)))):
            if size % k:
                raise ValueError(f"axis {n} of size {size} does not divide over {k} mesh positions "
                                 f"({self.spec} on a mesh of shape {self.mesh.shape})")

    def block_index(self, position: int, ndim: int) -> tuple:
        """The block index, along each array axis, of the mesh ``position``."""
        c = dict(zip(self.mesh.axis_names, self.mesh.coords(position)))
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for e in spec:
            i = 0
            for a in self._axes(e):
                i = i * self.mesh.axis_size(a) + c[a]
            out.append(i)
        return tuple(out)

    def _slices(self, position: int, shape) -> tuple:
        parts = self.parts(len(shape))
        return tuple(slice(i * (s // k), (i + 1) * (s // k))
                     for i, s, k in zip(self.block_index(position, len(shape)), shape, parts))

    def split(self, t: torch.Tensor) -> tuple:
        """The blocks of the whole tensor ``t``, each a contiguous copy (or
        ``t`` itself when it is whole and already there) on its position's
        device, in row-major mesh order; on a mesh that spans processes,
        those of this process's positions (``mesh.local_positions``)."""
        t = torch.as_tensor(t)
        self.check_shape(tuple(t.shape))
        return tuple(t[self._slices(p, tuple(t.shape))].to(self.mesh.devices[p]).contiguous()
                     for p in self.mesh.local_positions)

    def join(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The inverse of :meth:`split`: the whole tensor on the first mesh
        device (a block replicated over a mesh axis is read once)."""
        require_local(self.mesh, "NamedSharding.join")
        if len(blocks) != self.mesh.size:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {self.mesh.size} positions")
        b0 = blocks[0]
        parts = self.parts(b0.ndim)
        shape = tuple(s * k for s, k in zip(b0.shape, parts))
        dev0 = self.mesh.devices[0]
        out = torch.empty(shape, dtype=b0.dtype, device=dev0)
        seen = set()
        for p, b in enumerate(blocks):
            idx = self.block_index(p, b0.ndim)
            if idx not in seen:
                seen.add(idx)
                out[self._slices(p, shape)] = b.to(dev0)
        return out


def replicated(mesh: Mesh) -> NamedSharding:
    """Every position holds the whole array."""
    return NamedSharding(mesh, PartitionSpec())


def shard_along(mesh: Mesh, axis_name: str, ndim: int, array_axis: int = 0) -> NamedSharding:
    """``array_axis`` of an ``ndim``-axis array cut over the mesh axis
    ``axis_name``."""
    spec = [None] * ndim
    spec[array_axis] = axis_name
    return NamedSharding(mesh, PartitionSpec(*spec))


def distributed_init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join ``num_processes`` processes into one ``torch.distributed`` group
    (``init_process_group`` over ``tcp://coordinator_address``, ``nccl``
    where CUDA is present, else ``gloo``); a no-op for one process, as in
    the reference."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("distributed_init of several processes needs coordinator_address and process_id")
    torch.distributed.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method="tcp://" + coordinator_address,
        world_size=int(num_processes),
        rank=int(process_id),
    )


def psum(blocks: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of this process's blocks, added in mesh order on the first
    block's device; on a mesh that spans processes then summed over the
    processes (``torch.distributed.all_reduce``), so that every process
    holds the total (the reference's ``psum``)."""
    dev = blocks[0].device
    total = functools.reduce(torch.add, [b.to(dev) for b in blocks])
    if mesh is not None and mesh.spans_processes:
        total = total.clone()
        torch.distributed.all_reduce(total)
    return total
