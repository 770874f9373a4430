"""Solver state across the two packages, as numpy arrays.

A JAX solver state (``pycsou_tpu``), with each entry turned into a numpy
array, becomes the port's state with :func:`state_from_numpy`, and back
with :func:`state_to_numpy`.  The keys are the same in both packages, for
every layout: the fused TV engines (``x``, ``z0``, ``z1``, with ``_stats``
but for mega and element, which carry none, as in the reference), the
generic PDS (a stacked ``z``, ``_gstats``), APGD and the LASSO engine
(``x``, ``x_temp``, ``t``, ``n``, ``_stats`` or ``_gstats``) and PMYULA
(``x``, ``n``, ``count``, ``mmse_raw``, ``m2_raw``, the P^2 states in
``p2_raw``/``p2_ops`` and ``traces``), with ``it``, ``metric`` and the
histories.  Lists and dicts (the P^2 states) are converted entry by entry.
Integer entries (``n``, ``count``) stay integers (int32, as in JAX); the
iteration counter ``it`` is a device scalar in JAX and a Python int in the
port.

A row-sharded solver (``parallel.DistributedTVDeconv2D``) keeps ``x``,
``z0`` and ``z1`` as tuples of per-shard tensors: :func:`state_to_numpy`
joins each into one array, and :func:`shard_state_from_numpy` cuts the JAX
solver's gathered arrays into the shards of a mesh.  On a 2-D mesh
(``parallel.Spatial2DTVDeconv2D``) each is a grid: a tuple of ``n0`` row
tuples of ``n1`` blocks in mesh order, block ``(i, j)`` holding rows ``[i
h_loc, (i + 1) h_loc)`` and columns ``[j w_loc, (j + 1) w_loc)``.
:func:`shard_state_from_numpy` cuts a JAX ``Spatial2DTVDeconv2D`` state into
that grid when given a 2-D mesh, and :func:`state_to_numpy` joins a tuple of
row tuples along the columns and then the rows, so it needs no mesh.

Operators take the same numpy arrays as their JAX counterparts (a
``PolynomialOperator``'s coefficients as ``np.asarray(op.coeffs)``, a
``DenseOperator``'s matrix).  A JAX ``SparseOperator`` holds a BCOO matrix:
:func:`sparse_from_numpy` builds the port's from its ``data`` and
``indices`` as numpy arrays.

PMYULA's PRNG ``key`` has no counterpart: the port's sampler draws the
noise of sample ``n`` from a counter-based generator keyed by ``(seed,
n)`` and keeps no generator state.  :func:`state_from_numpy` drops the
``key``, so a JAX chain continues in the port from its ``x``, moments and
counters, with other noise.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pycsou_tpu_torch.utils.device import resolve_device

__all__ = ["shard_state_from_numpy", "sparse_from_numpy", "state_from_numpy", "state_to_numpy"]

_SHARDED = ("x", "z0", "z1")  # the per-shard entries of a row-sharded solver's state

_DROPPED = ("key",)  # JAX-only entries (see the module docstring)


def _to_torch(v, dev):
    if isinstance(v, dict):
        return {k: _to_torch(e, dev) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_torch(e, dev) for e in v]
    a = np.asarray(v)
    dtype = np.int32 if a.dtype.kind in "iu" else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def _to_numpy(v):
    if isinstance(v, dict):
        return {k: _to_numpy(e) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_numpy(e) for e in v]
    return v.detach().cpu().numpy()


def state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """Port state on ``device`` from a dict of numpy arrays, scalars, and
    lists or dicts of them; the JAX ``key`` is dropped."""
    dev = resolve_device(device)
    return {
        k: int(np.asarray(v)) if k == "it" else _to_torch(v, dev)
        for k, v in state.items() if k not in _DROPPED
    }


def shard_state_from_numpy(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A sharded solver's port state on ``mesh`` (a ``parallel.Mesh``) from
    the JAX solver's state as numpy arrays: ``x``, ``z0`` and ``z1`` cut into
    equal row shards on a 1-D mesh's devices, or into the grid of blocks of a
    2-D mesh; the rest (``_stats``, ``metric``, the histories) on the first
    device."""
    devices = mesh.devices
    n0, n1 = (len(devices), 1) if len(mesh.shape) == 1 else mesh.shape
    out = state_from_numpy({k: v for k, v in state.items() if k not in _SHARDED}, devices[0])
    for k in _SHARDED:
        a = np.asarray(state[k], np.float32)
        if a.shape[0] % n0 or a.shape[1] % n1:
            raise ValueError(f"{k}: {a.shape} does not divide over a {n0}x{n1} mesh")
        h, w = a.shape[0] // n0, a.shape[1] // n1

        def block(i, j):
            return torch.from_numpy(np.ascontiguousarray(a[i * h : (i + 1) * h, j * w : (j + 1) * w])).to(
                devices[i * n1 + j])

        if len(mesh.shape) == 1:
            out[k] = tuple(block(i, 0) for i in range(n0))
        else:
            out[k] = tuple(tuple(block(i, j) for j in range(n1)) for i in range(n0))
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """Dict of numpy arrays (lists and dicts kept) from a port state; ``it``
    as int32, the JAX package's type; a tuple of shards joined along its
    rows, a tuple of row tuples (a grid of blocks) along the columns and
    then the rows."""
    def join(v):
        if isinstance(v, tuple):
            return np.concatenate([np.concatenate([_to_numpy(b) for b in t], axis=1) if isinstance(t, tuple)
                                   else _to_numpy(t) for t in v])
        return _to_numpy(v)

    def one(k, v):
        return np.asarray(v, dtype=np.int32) if k == "it" else join(v)

    return {k: one(k, v) for k, v in state.items()}


def sparse_from_numpy(data, indices, shape, dim_shape=None, codim_shape=None, device=None):
    """The port's ``SparseOperator`` of the COO matrix ``(data, indices)``
    of ``shape``: ``indices`` is ``(nnz, 2)`` (row, column), as a BCOO's
    ``indices`` and ``data`` (``np.asarray(op.mat.indices)``,
    ``np.asarray(op.mat.data)``)."""
    import scipy.sparse as sp

    from pycsou_tpu_torch.ops.basic import SparseOperator

    idx = np.asarray(indices)
    mat = sp.coo_matrix((np.asarray(data), (idx[:, 0], idx[:, 1])), shape=tuple(shape))
    return SparseOperator(mat, dim_shape=dim_shape, codim_shape=codim_shape, device=device)
