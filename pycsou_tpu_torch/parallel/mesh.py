"""Device meshes (counterpart of ``pycsou_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of torch devices with named axes, driven by one
process, as the reference's ``jax.sharding.Mesh`` is under ``shard_map``: a
sharded solver keeps one block per mesh position on that position's device
and runs each block's kernels in mesh order.  A device may appear more than
once, so a mesh of four shards can live on one card
(``make_mesh((4,), devices=[torch.device("cuda", 0)] * 4)``); the CPU tests
use ``devices=["cpu"] * n``.  :func:`make_mesh_2d` gives the reference's
default ``(sp0, sp1)`` shape for ``Spatial2DTVDeconv2D``.  Meshes across
processes or hosts (``torch.distributed``) are not ported yet (ROADMAP
Queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "mesh_shape_2d"]


class Mesh:
    """``devices``: a flat tuple of ``torch.device`` in row-major mesh order;
    ``shape``: the mesh's shape (default: one axis over all the devices);
    ``axis_names``: one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str], shape: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = (len(self.devices),) if shape is None else tuple(int(s) for s in shape)
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"a mesh of shape {self.shape} needs {math.prod(self.shape)} devices, "
                             f"got {len(self.devices)}")
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.shape} needs {len(self.shape)} axis names, "
                             f"got {self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh(shape={self.shape}, axis_names={self.axis_names}, devices={self.devices})"


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("sp",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device, each
    once), the first ``prod(shape)`` of them in order, of shape ``shape``
    (default: one axis over all of them).

        >>> make_mesh((4,), devices=["cpu"] * 4).shape
        (4,)

    Without CUDA and without ``devices`` it raises: pass ``devices=`` (for
    example ``["cpu"] * n``).  It never repeats a device on its own; a mesh
    of several shards on one card names that card several times."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch.cuda.is_available() is False; pass devices= (for example "
                '["cpu"] * n, or [torch.device("cuda", 0)] * n for n shards on one card)'
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    shape = (len(devices),) if shape is None else tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > len(devices) or n < 1:
        raise ValueError(f"mesh of shape {shape} needs {n} devices, {len(devices)} given")
    return Mesh(devices[:n], axis_names, shape)


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
    card)."""
    if devices is None:
        devices = make_mesh().devices
    return make_mesh(mesh_shape_2d(len(devices)), axis_names, devices)
