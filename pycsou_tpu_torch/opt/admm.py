"""Consensus ADMM over a device mesh (counterpart of ``pycsou_tpu/opt/admm.py``).

``min_x sum_i f_i(x) + g(x)`` with the scenario terms ``f_i = ||A_i x -
y_i||^2`` split over the devices of a mesh.  One iteration::

    x_i = argmin_x ||A_i x - y_i||^2 + (rho/2)||x - (z - u_i)||^2   (a block's)
    z   = prox_{g/(S rho)}( mean_i (x_i + u_i) )                    (the sum)
    u_i = u_i + x_i - z                                             (a block's)

The reference runs the blocks under ``shard_map`` and sums them with
``psum``.  Here one process drives a :class:`~pycsou_tpu_torch.parallel.Mesh`:
mesh position b holds its ``S / size`` scenarios (data, transfer
functions, ``u``) on its device; each block's ``x + u`` is summed there,
the block sums are added on the first device (``z``'s), the prox runs
there, and the new ``z`` goes back to each block.  On one card that is one
block and no copy.

Two x-update backends:

* **Fourier** (``h_hats``, circular convolutions): ``X = (2 conj(H) Y +
  rho V) / (2 |H|^2 + rho)``, one batched ``rfftn`` a block (``2 conj(H) Y``
  and the denominator made once);
* **CG** (``ops`` from :func:`stack_operators`): one batched CG a block on
  ``(2 A_i^H A_i + rho I) x_i = 2 A_i^H y_i + rho v_i``
  (``utils.opnorm.cg(batched=True)``: each row stops on its own test with
  its state frozen, as the reference's ``jax.vmap`` of
  ``jax.scipy.sparse.linalg.cg``), its matvec applied row by row, since an
  operator that launches K1 cannot be vmapped.
"""
from __future__ import annotations

from typing import Optional

import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums, _rel_improvement
from pycsou_tpu_torch.parallel.mesh import Mesh, make_mesh
from pycsou_tpu_torch.utils.device import as_tensor
from pycsou_tpu_torch.utils.opnorm import cg
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["ConsensusADMM", "stack_operators"]

_STRUCTURE = (bool, int, str)  # attribute types that must agree across stacked operators


def _structure(op):
    """What the reference's pytree structure pins: the class, shapes, dtype
    and every bool, int, str or tuple attribute.  Float attributes (a
    Lipschitz bound) are data here: they differ with the operator's values."""
    def static(v):
        return isinstance(v, _STRUCTURE) or (isinstance(v, tuple) and all(isinstance(e, _STRUCTURE) for e in v))

    fields = {k: v for k, v in vars(op).items() if static(v)}
    return type(op), op.dim_shape, op.codim_shape, op.dtype, fields


def stack_operators(ops) -> tuple:
    """The S scenario operators of :class:`ConsensusADMM`'s CG backend as a
    tuple, after the reference's check that they share class, shapes and
    structure (a mix raises ``ValueError``).  The port's operators are
    plain objects, not pytrees: scenario i's operator is ``ops[i]``."""
    ops = tuple(ops)
    if len(ops) == 0:
        raise ValueError("need at least one operator")
    first = _structure(ops[0])
    for op in ops[1:]:
        if _structure(op) != first:
            raise ValueError("operators must share class, shapes and static fields")
    return ops


class ConsensusADMM(IterativeSolver):
    """Data-parallel consensus ADMM.

    Parameters
    ----------
    dim_shape : shape of the shared unknown.
    h_hats    : (S, *rfftn_shape) complex: per-scenario circular-convolution
                transfer functions (the Fourier x-update), or None.
    data      : (S, *codim_shape): per-scenario measurements.
    g         : optional proximable regulariser on z.
    rho       : ADMM penalty.
    ops       : :func:`stack_operators` of the S scenario operators (the CG
                x-update), or None.  Exactly one of ``h_hats`` and ``ops``.
    mesh      : a 1-D :class:`~pycsou_tpu_torch.parallel.Mesh`; None means
                ``make_mesh(axis_names=(axis_name,))``, every visible card
                once (without CUDA that raises: pass ``mesh=make_mesh(
                axis_names=("dp",), devices=["cpu"] * n)``).  S must divide
                over its size.
    cg_tol / cg_maxiter : the inner CG's controls (CG backend).

    The state is ``{"z", "u"}``: ``z`` on the mesh's first device, ``u`` a
    tuple of per-block ``(S / size, *dim_shape)`` tensors;
    ``postprocess`` joins ``u`` on the first device and adds ``"x"``, an
    alias of ``z``."""

    primary_var = "z"

    def __init__(
        self,
        dim_shape,
        h_hats=None,
        data=None,
        g=None,
        rho: float = 1.0,
        ops: Optional[tuple] = None,
        mesh: Optional[Mesh] = None,
        axis_name: str = "dp",
        cg_tol: float = 1e-6,
        cg_maxiter: int = 50,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        if (h_hats is None) == (ops is None):
            raise ValueError("pass exactly one of h_hats (Fourier) or ops (CG)")
        self.dim_shape = as_shape(dim_shape)
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(axis_name,))
        self.axis_name = self.mesh.axis_names[0]
        devices = self.mesh.devices
        S = int(data.shape[0])
        if S % len(devices):
            raise ValueError(f"number of scenarios {S} must divide over {len(devices)} devices")
        self.S = S
        self.g = g
        self.rho = float(rho)
        self.cg_tol = float(cg_tol)
        self.cg_maxiter = int(cg_maxiter)
        per = S // len(devices)
        self._rows = [slice(b * per, (b + 1) * per) for b in range(len(devices))]
        self.data = tuple(as_tensor(data[r], dev) for r, dev in zip(self._rows, devices))
        self.ops = ops
        self._num = self._den = None
        if h_hats is not None:
            axes = self._axes()
            self._num, self._den = [], []
            for r, dev, y in zip(self._rows, devices, self.data):
                h = as_tensor(h_hats[r], dev, torch.complex64)
                self._num.append(2.0 * torch.conj(h) * torch.fft.rfftn(y, dim=axes))
                self._den.append(2.0 * torch.abs(h) ** 2 + self.rho)

    def _axes(self):
        """The last nd axes of a block (its scenarios lead)."""
        nd = len(self.dim_shape)
        return tuple(range(1, nd + 1))

    # -- a block's x-update ----------------------------------------------------
    def _x_update_fourier(self, b: int, v):
        axes = self._axes()
        X = (self._num[b] + self.rho * torch.fft.rfftn(v, dim=axes)) / self._den[b]
        return torch.fft.irfftn(X, s=self.dim_shape, dim=axes)

    def _x_update_cg(self, b: int, v):
        ops = self.ops[self._rows[b]]
        rho = self.rho
        rhs = torch.stack([2.0 * op.adjoint(y) for op, y in zip(ops, self.data[b])]) + rho * v

        def mv(w):
            return torch.stack([2.0 * op.adjoint(op.apply(wi)) for op, wi in zip(ops, w)]) + rho * w

        return cg(mv, rhs, x0=v, tol=self.cg_tol, maxiter=self.cg_maxiter, batched=True)

    # -- IterativeSolver protocol ------------------------------------------------
    def initial_state(self):
        devices = self.mesh.devices
        z = torch.zeros(self.dim_shape, device=devices[0])
        u = tuple(torch.zeros((r.stop - r.start,) + self.dim_shape, device=dev)
                  for r, dev in zip(self._rows, devices))
        return {"z": z, "u": u}

    def step(self, state):
        z, us = state["z"], state["u"]
        update = self._x_update_fourier if self.ops is None else self._x_update_cg
        xs = []
        for b, (dev, u) in enumerate(zip(self.mesh.devices, us)):
            v = z.to(dev, non_blocking=True)[None] - u
            xs.append(update(b, v))
        return self._consensus(xs, us, z)

    def _consensus(self, xs, us, z_prev):
        """The z-update (the reference's ``psum``: each block's sum of ``x +
        u``, the block sums added on z's device) and the dual ascent."""
        dev0 = z_prev.device
        total = None
        for x, u in zip(xs, us):
            part = torch.sum(x + u, dim=0).to(dev0, non_blocking=True)
            total = part if total is None else total + part
        mean = total / self.S
        z = self.g.prox(mean, 1.0 / (self.S * self.rho)) if self.g is not None else mean
        u_new = tuple(u + x - z.to(x.device, non_blocking=True)[None] for x, u in zip(xs, us))
        return {"z": z, "u": u_new}

    def metrics(self, old, new):
        """Relative improvements of ``z`` and of all the blocks of ``u``."""
        dev0 = new["z"].device
        d2 = o2 = None
        for uo, un in zip(old["u"], new["u"]):
            d = un - uo
            dd, oo = torch.sum(d * d).to(dev0), torch.sum(uo * uo).to(dev0)
            d2, o2 = (dd, oo) if d2 is None else (d2 + dd, o2 + oo)
        return {"z": _rel_improvement(old["z"], new["z"]), "u": _rel_from_sums(d2, o2)}

    def postprocess(self, state):
        out = dict(super().postprocess(state))
        dev0 = out["z"].device
        out["u"] = torch.cat([u.to(dev0) for u in out["u"]])
        out["x"] = out["z"]  # the reference's primal alias
        return out

    # -- the legacy fixed-iteration API ------------------------------------------
    def run(self, n_iters: int, z0=None):
        """``n_iters`` consensus iterations (from ``z0``, zero by default);
        returns the consensus ``z``."""
        state = None
        if z0 is not None:
            state = self.initial_state()
            state["z"] = as_tensor(z0, self.mesh.devices[0])
        return self.run_fixed(n_iters, state=state)["z"]
