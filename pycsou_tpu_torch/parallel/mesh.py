"""Device meshes and shardings (counterpart of ``pycsou_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of torch devices with named axes, as the
reference's ``jax.sharding.Mesh`` is under ``shard_map``: a sharded solver
keeps one block per mesh position on that position's device and runs each
block's kernels in mesh order.  A device may appear more than once, so a
mesh of four shards can live on one card (``make_mesh((4,),
devices=[torch.device("cuda", 0)] * 4)``); the CPU tests use
``devices=["cpu"] * n``.  :func:`make_mesh_2d` gives the reference's
default ``(sp0, sp1)`` shape for ``Spatial2DTVDeconv2D``.

A :class:`NamedSharding` pairs a mesh with a :class:`PartitionSpec` (one
mesh-axis name, or None, per array axis) and cuts a whole tensor into the
blocks of this process's mesh positions (:meth:`NamedSharding.split`) or
joins them (:meth:`NamedSharding.join`); :func:`replicated` and
:func:`shard_along` build the reference's two common ones.  They describe
the ``x=`` of ``solver.with_shardings`` and the blocks of
``parallel/sharded.py``.

After :func:`distributed_init` (``torch.distributed`` over TCP; CPU tensors
over ``gloo`` and CUDA tensors over ``nccl`` by default), :func:`make_mesh`
spans every process: ``world_size`` times the local devices (by default the
process's current card), each position recording its process's rank.  Each
process builds the same solver or operator from the same whole inputs and
keeps the blocks of its own positions (``mesh.local_positions``); a
sharded value is then a tuple with one entry a position, a
:class:`~pycsou_tpu_torch.utils.device.Remote` for each position another
process holds (:meth:`Mesh.place`).  The collectives below move what
crosses a process boundary, and nothing else:

* :func:`transfer` posts point-to-point messages in one
  ``batch_isend_irecv`` (every send and receive at once, so that no order
  can deadlock); the halo exchanges of ``parallel/spatial.py`` and
  :func:`all_to_all` (the pencil FFT's) are built on it;
* :func:`gather_positions` gives every process every position's block (the
  joins, :meth:`NamedSharding.join`);
* :func:`fold` adds one term a position in mesh order after gathering
  them, so that a metric, a ``psum`` or a consensus sum is bit for bit that
  of the same mesh driven by one process.

Where the group's backend for CUDA tensors is ``gloo`` (``backend="gloo"``,
for several processes on one card), CUDA tensors cross through pinned host
buffers by explicit copies; under ``nccl`` they go as they are.  Between
positions of one process nothing is sent: a neighbour's rows are a view, or
a ``.to(device)`` copy on another card.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import torch

from pycsou_tpu_torch.utils.device import Remote

__all__ = [
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "Remote",
    "all_to_all",
    "distributed_init",
    "each",
    "fold",
    "gather_positions",
    "make_mesh",
    "make_mesh_2d",
    "mesh_shape_2d",
    "psum",
    "replicated",
    "shard_along",
    "transfer",
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


def _backend_for(device) -> Optional[str]:
    """The backend that carries tensors of ``device``'s type in the
    default group (``"gloo"`` or ``"nccl"``), None when no group is
    joined."""
    if not _joined():
        return None
    spec = str(torch.distributed.get_backend())
    if ":" not in spec:
        return spec
    per_type = dict(e.split(":") for e in spec.split(","))
    return per_type.get(torch.device(device).type)


def _cuda_devices() -> list:
    """The devices a mesh takes by default: every visible CUDA device once;
    after :func:`distributed_init` of several processes, the process's
    current card (``torch.cuda.current_device()``, which the caller sets,
    as ``torchrun`` users do); without CUDA, ``RuntimeError``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: torch.cuda.is_available() is False; pass devices= (for example "
            '["cpu"] * n, or [torch.device("cuda", 0)] * n for n shards on one card)'
        )
    if _world() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """``devices``: a flat tuple of ``torch.device`` in row-major mesh order;
    ``shape``: the mesh's shape (default: one axis over all the devices);
    ``axis_names``: one name per axis; ``ranks``: the process rank of each
    position (default: this process's, for all of them).
    ``process_index`` is this process's rank and ``local_positions`` the
    positions it drives; the device of another process's position is a
    label only.  ``backend`` is the group's backend for the mesh's device
    type (None when the mesh does not span processes)."""

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
        self.backend = _backend_for(self.devices[0]) if self.spans_processes else None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        """Whether the positions belong to more than one process."""
        return len(set(self.ranks)) > 1

    @property
    def local_device(self) -> torch.device:
        """The device of this process's first position: where its joined
        tensors, metrics and histories live (the first device when it holds
        none)."""
        return self.devices[self.local_positions[0] if self.local_positions else 0]

    def place(self, local_blocks: Sequence) -> tuple:
        """One entry a mesh position from the blocks of this process's
        positions (in their order): a :class:`Remote` for each other
        position.  A sequence of one entry a position is returned as a
        tuple."""
        local_blocks = tuple(local_blocks)
        if len(local_blocks) == self.size:
            return local_blocks
        if len(local_blocks) != len(self.local_positions):
            raise ValueError(f"{len(local_blocks)} blocks for {len(self.local_positions)} local positions of a "
                             f"mesh of {self.size}")
        out = [Remote(r) for r in self.ranks]
        for p, b in zip(self.local_positions, local_blocks):
            out[p] = b
        return tuple(out)

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

    def axis_positions(self, name: str) -> tuple:
        """The positions along the axis ``name``, every other coordinate 0."""
        k = self.axis_names.index(name)
        return tuple(p for p in range(self.size)
                     if all(c == 0 for j, c in enumerate(self.coords(p)) if j != k))

    def __repr__(self):
        procs = f", ranks={self.ranks}" if self.spans_processes else ""
        return f"Mesh(shape={self.shape}, axis_names={self.axis_names}, devices={self.devices}{procs})"


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
    process's local devices (the same count in every process; by default
    the process's current card), and the mesh runs over ``world_size``
    times them, rank by rank."""
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
        """The inverse of :meth:`split`: the whole tensor on this process's
        first mesh device (a block replicated over a mesh axis is read
        once).  ``blocks`` are this process's (as :meth:`split` gives them)
        or one entry a position; on a mesh that spans processes the others'
        arrive by :func:`gather_positions`, so every process gets the whole
        tensor (every process must call it)."""
        blocks = gather_positions(self.mesh.place(blocks))
        b0 = blocks[0]
        parts = self.parts(b0.ndim)
        shape = tuple(s * k for s, k in zip(b0.shape, parts))
        dev0 = self.mesh.local_device
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
                     process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join ``num_processes`` processes into one ``torch.distributed`` group
    (``init_process_group`` over ``tcp://coordinator_address``); a no-op
    for one process, as in the reference.  ``backend`` defaults to
    ``"cpu:gloo,cuda:nccl"`` where CUDA is present (CPU tensors over gloo,
    CUDA tensors over NCCL) and ``"gloo"`` otherwise; ``backend="gloo"``
    carries CUDA tensors through host buffers, for several processes on one
    card, which NCCL refuses."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("distributed_init of several processes needs coordinator_address and process_id")
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend=backend,
        init_method="tcp://" + coordinator_address,
        world_size=int(num_processes),
        rank=int(process_id),
    )


# -- the collectives ---------------------------------------------------------------


def each(fn, *seqs) -> list:
    """``fn`` over the positions whose entry in the first of ``seqs`` this
    process holds; a :class:`Remote` entry stays as it is."""
    return [s[0] if isinstance(s[0], Remote) else fn(*s) for s in zip(*seqs)]


def _staged(device: torch.device) -> bool:
    """Whether tensors of ``device`` cross through host buffers: CUDA
    tensors where the group carries them over gloo."""
    return device.type == "cuda" and _backend_for(device) != "nccl"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend sends it: contiguous, on a pinned host buffer
    when staged."""
    t = t.contiguous()
    if not _staged(t.device):
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)  # device to pinned host: waits for t's stream
    return buf


def transfer(messages: Sequence[tuple]) -> List[Optional[torch.Tensor]]:
    """Post point-to-point messages in one ``batch_isend_irecv`` and wait for
    them all.  ``messages``: ``(tag, src, dst, payload, like)``, in an order
    that every process builds alike (the pairs' sends and receives then
    match); ``payload`` is the tensor this process sends where it is
    ``src``, ``like`` a tensor of the shape and dtype it receives, on the
    device it wants it, where it is ``dst``.  Returns, for each message,
    what arrived here (None where this process is not ``dst``).
    ``transfer.sent_bytes`` and ``transfer.sent_messages`` count what this
    process sent."""
    me = _rank()
    ops, got = [], {}
    P2POp = torch.distributed.P2POp
    for k, (tag, src, dst, payload, like) in enumerate(messages):
        if src == me and dst != me:
            wire = _to_wire(payload)
            transfer.sent_bytes += wire.numel() * wire.element_size()
            transfer.sent_messages += 1
            ops.append(P2POp(torch.distributed.isend, wire, dst, tag=tag))
        elif dst == me and src != me:
            staged = _staged(like.device)
            buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device,
                              pin_memory=staged)
            got[k] = buf
            ops.append(P2POp(torch.distributed.irecv, buf, src, tag=tag))
    if ops:
        for req in torch.distributed.batch_isend_irecv(ops):
            req.wait()
    return [got[k].to(m[4].device) if k in got else None for k, m in enumerate(messages)]


transfer.sent_bytes = 0
transfer.sent_messages = 0


def _holder(entry, me: int) -> int:
    return entry.rank if isinstance(entry, Remote) else me


def gather_positions(entries: Sequence) -> list:
    """Every position's tensor, from one entry a position (this process's
    blocks and a :class:`Remote` for each other): each block is sent to
    every other process that holds a position, and arrives on the device of
    this process's first block, with its shape and dtype (the blocks of one
    sharded value are alike).  Without a ``Remote`` entry, ``entries`` as a
    list."""
    entries = list(entries)
    if not any(isinstance(e, Remote) for e in entries):
        return entries
    me = _rank()
    like = next(e for e in entries if not isinstance(e, Remote))
    ranks = sorted({_holder(e, me) for e in entries})
    msgs, where = [], []
    for p, e in enumerate(entries):
        src = _holder(e, me)
        for r in ranks:
            if r != src:
                msgs.append((len(msgs), src, r, None if src != me else e, like))
                where.append(p)
    out = list(entries)
    for p, got in zip(where, transfer(msgs)):
        if got is not None:
            out[p] = got
    return out


def fold(terms: Sequence) -> torch.Tensor:
    """The sum of one term a mesh position, added in mesh order on the first
    local term's device (the reference's ``psum``); the terms of other
    processes' positions (:class:`Remote` entries) are gathered first, so
    every process holds the same total, bit for bit that of the same mesh
    driven by one process."""
    terms = list(terms)
    dev = next(t for t in terms if not isinstance(t, Remote)).device
    return functools.reduce(torch.add, [t.to(dev) for t in gather_positions(terms)])


def psum(blocks: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of the blocks, added in mesh order on the first block's
    device; given a mesh that spans processes, ``blocks`` are this
    process's (or one entry a position) and the total is :func:`fold`'s
    over every position, so that every process holds it."""
    if mesh is not None and mesh.spans_processes:
        return fold(mesh.place(blocks))
    dev = blocks[0].device
    return functools.reduce(torch.add, [b.to(dev) for b in blocks])


def all_to_all(pieces: Sequence[Sequence], devices: Sequence[torch.device]) -> list:
    """``pieces[i][j]``, the piece position i sends to position j (a tensor
    where this process holds i, else a :class:`Remote` row), delivered:
    entry ``[j][i]`` on ``devices[j]`` for each position j this process
    holds (a :class:`Remote` row for the others).  Between positions of one
    process a piece is copied where the two devices differ; across
    processes it is sent."""
    n, me = len(pieces), _rank()
    holders = [_holder(row, me) for row in pieces]
    msgs, out = [], [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(n):
            src, dst = holders[i], holders[j]
            if src == me and dst == me:
                out[j][i] = pieces[i][j].to(devices[j], non_blocking=True)
            elif src != dst and me in (src, dst):
                like = pieces[j][j] if dst == me else None
                msgs.append((j * n + i, src, dst, pieces[i][j] if src == me else None, like))
    for (tag, src, dst, _, _), got in zip(msgs, transfer(msgs)):
        if got is not None:
            j, i = divmod(tag, n)
            out[j][i] = got.to(devices[j])
    return [Remote(holders[j]) if holders[j] != me else out[j] for j in range(n)]
