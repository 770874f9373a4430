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
``z0`` and ``z1`` (or, on the chain, ``x`` and a stacked ``z`` of ``(2,
h_loc, W)`` shards) as tuples of per-shard tensors: :func:`state_to_numpy`
joins each along its rows, and :func:`shard_state_from_numpy` cuts the JAX
solver's gathered arrays into the shards of a mesh.  On a 2-D mesh
(``parallel.Spatial2DTVDeconv2D``) each is a grid: a tuple of ``n0`` row
tuples of ``n1`` blocks in mesh order, block ``(i, j)`` holding rows ``[i
h_loc, (i + 1) h_loc)`` and columns ``[j w_loc, (j + 1) w_loc)``.
:func:`shard_state_from_numpy` cuts a JAX ``Spatial2DTVDeconv2D`` state into
that grid when given a 2-D mesh, and :func:`state_to_numpy` joins a tuple of
row tuples along the columns and then the rows, so it needs no mesh.  A
batch (``parallel.BatchedDistributedTVDeconv2D``: ``x`` of ``(B, H, W)``)
is cut over a ``(dp, sp)`` mesh into bricks, ``B / dp`` images by ``H /
sp`` rows, and joined back the same way.

Where the JAX solver and the port's keep the duals in different layouts
(the generic PDS's or the chain's stacked ``z`` against a fused engine's
``z0`` and ``z1``), pass the port solver's fresh state as ``like=``: the
duals are split or stacked to its layout (the per-variable history then
dropped: the solver starts a new one), an entry it lacks (the reference's
``key``, another engine's partial sums) is dropped and one it has that the
JAX state lacks is taken from it.

``ConsensusADMM`` keeps ``u`` as a tuple of per-block tensors, ``S /
size`` scenarios a mesh position: :func:`consensus_state_from_numpy` cuts
the JAX solver's ``u`` into them (``z`` and the rest on the first device),
and :func:`state_to_numpy` joins them along the scenarios.  A JAX transfer
function stored as re/im pairs (``h_hat_re``, ``h_hat_im`` of the JAX
convolutions) becomes one complex tensor with :func:`transfer_from_numpy`.

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

__all__ = ["consensus_state_from_numpy", "shard_state_from_numpy", "sparse_from_numpy", "state_from_numpy",
           "state_to_numpy", "transfer_from_numpy"]

_SHARDED = ("x", "z0", "z1", "z")  # the per-shard entries of a sharded solver's state

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


_KEPT = ("it", "metric", "history", "var_history", "obj_history")


def _relayout(state: Dict[str, Any], like) -> Dict[str, Any]:
    """``state`` (numpy) in the layout of the port state ``like``: the duals
    stacked or split, the entries ``like`` lacks dropped, those it has
    and ``state`` lacks taken from ``like`` (as numpy)."""
    state = dict(state)
    if "z" in like and "z" not in state and "z0" in state:
        state["z"] = np.stack([np.asarray(state.pop("z0")), np.asarray(state.pop("z1"))], axis=-3)
        state.pop("var_history", None)  # its columns are the other layout's variables
    if "z0" in like and "z0" not in state and "z" in state:
        z = np.asarray(state.pop("z"))
        state["z0"], state["z1"] = z[..., 0, :, :], z[..., 1, :, :]
        state.pop("var_history", None)
    out = {k: v for k, v in state.items() if k in like or k in _KEPT}
    for k, v in like.items():
        if k not in out:
            out[k] = _join(k, v, like) if isinstance(v, tuple) else (
                v if isinstance(v, int) else _to_numpy(v))
    return out


def state_from_numpy(state: Dict[str, Any], device, like=None) -> Dict[str, Any]:
    """Port state on ``device`` from a dict of numpy arrays, scalars, and
    lists or dicts of them; the JAX ``key`` is dropped.  ``like``, a fresh
    state of the port solver, sets the layout of the duals (see the module
    docstring)."""
    dev = resolve_device(device)
    if like is not None:
        state = _relayout(state, like)
    return {
        k: int(np.asarray(v)) if k == "it" else _to_torch(v, dev)
        for k, v in state.items() if k not in _DROPPED
    }


def shard_state_from_numpy(state: Dict[str, Any], mesh, like=None) -> Dict[str, Any]:
    """A sharded solver's port state on ``mesh`` (a ``parallel.Mesh``) from
    the JAX solver's state as numpy arrays: ``x``, ``z0``, ``z1`` and ``z``
    cut along their rows into equal shards on a 1-D mesh's devices, or into
    the grid of blocks of a 2-D mesh, or, for a batch (``x`` of ``(B, H,
    W)``), into the bricks of a ``(dp, sp)`` mesh; the rest (``_stats``,
    ``metric``, the histories) on the first device.  ``like`` as
    :func:`state_from_numpy`'s."""
    if like is not None:
        state = _relayout(state, like)
    devices = mesh.devices
    n0, n1 = (len(devices), 1) if len(mesh.shape) == 1 else mesh.shape
    batched = np.ndim(state["x"]) == 3
    out = state_from_numpy({k: v for k, v in state.items() if k not in _SHARDED}, devices[0])
    for k in _SHARDED:
        if k not in state:
            continue
        a = np.asarray(state[k], np.float32)
        if batched:
            rows, cols = (a.shape[0] // n0, a.shape[-2] // n1), None
            if a.shape[0] % n0 or a.shape[-2] % n1:
                raise ValueError(f"{k}: {a.shape} does not divide over a {n0}x{n1} (dp, sp) mesh")
        elif a.shape[-2] % n0 or a.shape[-1] % n1:
            raise ValueError(f"{k}: {a.shape} does not divide over a {n0}x{n1} mesh")
        else:
            rows, cols = a.shape[-2] // n0, a.shape[-1] // n1

        def block(i, j):
            if batched:
                b, h = rows
                part = a[i * b : (i + 1) * b, ..., j * h : (j + 1) * h, :]
            else:
                part = a[..., i * rows : (i + 1) * rows, j * cols : (j + 1) * cols]
            return torch.from_numpy(np.ascontiguousarray(part)).to(devices[i * n1 + j])

        if len(mesh.shape) == 1:
            out[k] = tuple(block(i, 0) for i in range(n0))
        else:
            out[k] = tuple(tuple(block(i, j) for j in range(n1)) for i in range(n0))
    return out


def consensus_state_from_numpy(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A ``ConsensusADMM`` port state on ``mesh`` from the JAX solver's
    state as numpy arrays: ``u`` (S, ...) cut into ``S / size`` scenarios a
    mesh device, the rest (``z``, ``metric``, the histories) on the first
    device."""
    devices = mesh.devices
    out = state_from_numpy({k: v for k, v in state.items() if k != "u"}, devices[0])
    u = np.asarray(state["u"], np.float32)
    if u.shape[0] % len(devices):
        raise ValueError(f"u: {u.shape[0]} scenarios do not divide over {len(devices)} devices")
    per = u.shape[0] // len(devices)
    out["u"] = tuple(torch.from_numpy(np.array(u[b * per : (b + 1) * per])).to(dev)
                     for b, dev in enumerate(devices))
    return out


def transfer_from_numpy(re, im, device=None) -> torch.Tensor:
    """The complex64 transfer function ``re + 1j im`` on ``device`` from a
    JAX re/im pair as numpy arrays."""
    h = np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
    return torch.from_numpy(h.astype(np.complex64)).to(resolve_device(device))


def _join(k, v, state) -> np.ndarray:
    """A sharded entry of ``state`` joined into one array: ConsensusADMM's
    ``u`` along its scenarios, a batch's bricks along the rows and then
    the batch, a tuple of shards along the rows, a grid along the columns
    and then the rows."""
    if k == "u":
        return np.concatenate([_to_numpy(t) for t in v])
    if not isinstance(v[0], tuple):
        return np.concatenate([_to_numpy(t) for t in v], axis=-2)
    if "x" in state and state["x"][0][0].ndim == 3:  # the bricks of a batch
        return np.concatenate([np.concatenate([_to_numpy(b) for b in row], axis=-2) for row in v])
    return np.concatenate([np.concatenate([_to_numpy(b) for b in row], axis=-1) for row in v], axis=-2)


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """Dict of numpy arrays (lists and dicts kept) from a port state; ``it``
    as int32, the JAX package's type; a sharded entry joined into one array
    (a tuple of shards along the rows, a grid of blocks along the columns
    and then the rows, a batch's bricks along the rows and then the batch,
    ``u`` along the scenarios)."""
    def one(k, v):
        if k == "it":
            return np.asarray(v, dtype=np.int32)
        return _join(k, v, state) if isinstance(v, tuple) else _to_numpy(v)

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
