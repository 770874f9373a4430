"""Sharded TV deconvolution on a mesh of devices (counterpart of
``pycsou_tpu/parallel/solvers.py`` ``DistributedTVDeconv2D``,
``BatchedDistributedTVDeconv2D`` and ``Spatial2DTVDeconv2D``).

The image, the data and the duals are cut into row shards over a 1-D
:class:`~pycsou_tpu_torch.parallel.mesh.Mesh`; one PDS iteration takes each
shard's neighbour halos (``parallel/spatial.py``) and launches one fused
shard kernel per shard, in mesh order, as the reference's ``shard_map``
runs its per-shard Pallas kernel on every device.  The six metric partial
sums are added over the shards in mesh order on the first local mesh
device (the reference's ``psum``, ``parallel.mesh.fold``).  The state is a
dict of per-shard tuples (``x``, ``z0``, ``z1``) and ``_stats``, so
``IterativeSolver``'s metric, histories and ``solve()`` apply unchanged.

Where no fused engine runs (``use_pallas=False``, or ``"auto"`` on CPU
devices) the solvers step the reference's chain of sharded operators
(``parallel/spatial.py``: the band or FFT Gram, the finite differences,
the prox) on every shard in mesh order, with the state ``{"x", "z"}``:
``z`` a tuple of ``(2, h_loc, W)`` shards (a grid of ``(2, h_loc,
w_loc)`` blocks on a 2-D mesh) and the metric from the shards' sums.

:class:`Spatial2DTVDeconv2D` cuts the image into a grid of blocks over a 2-D
``(sp0, sp1)`` mesh and runs one fused block kernel per block (K17, or K15
when the columns are not cut); its state holds a tuple of row tuples of
blocks.  :class:`BatchedDistributedTVDeconv2D` runs a batch of images on a
``(dp, sp)`` mesh: each image on the chain of one mesh row, no exchange
between rows.

On a mesh that spans processes (``parallel.distributed_init``) each
process builds the solver from the same whole inputs and keeps the blocks
of its own positions: a sharded entry has a ``Remote`` where another
process holds the block, and each process launches one kernel for each of
its positions.  The halos that cross a process boundary, the partial sums
and the joins (``postprocess``, ``run``, ``objective``) go through
``torch.distributed``; the sums fold in mesh order, so the iterates, the
metric history and ``converged_at`` are bit for bit those of the same mesh
driven by one process, and every process holds the joined result.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.kernels.band import make_gram_band
from pycsou_tpu_torch.kernels.conv2d import MAX_TAPS, SepFactors, sepconv2d
from pycsou_tpu_torch.kernels.tv import tv_pds_mega2_shard_step, tv_pds_sweep_shard_step
from pycsou_tpu_torch.kernels.tvr import HALO_COLS, tv_pds_megar_shard2d_step, tv_pds_megar_shard_step
from pycsou_tpu_torch.ops._gram import conv_full_direct
from pycsou_tpu_torch.ops.conv import Convolve2D, lowrank_factors
from pycsou_tpu_torch.opt.tv import rank1_gate
from pycsou_tpu_torch.parallel.mesh import Mesh, each, fold, gather_positions, make_mesh, make_mesh_2d
from pycsou_tpu_torch.parallel.spatial import (
    conv_transfer,
    halo_extend,
    halo_extend_2d,
    halos,
    halos_2d,
    lane_extend,
    pdot,
    sharded_conv2d,
    sharded_conv2d_adjoint,
    sharded_conv2d_gram,
    sharded_grad2d,
    sharded_grad2d_2d,
    sharded_grad2d_adjoint,
    sharded_grad2d_adjoint_2d,
    sharded_sepconv2d_2d,
    sharded_sepconv2d_adjoint_2d,
    sharded_sepgram_rank1,
    sharded_sepgram_rank1_2d,
)
from pycsou_tpu_torch.utils.device import Remote, as_tensor
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["DistributedTVDeconv2D", "BatchedDistributedTVDeconv2D", "Spatial2DTVDeconv2D"]

# halo rows per engine: megasp's K14 reads the padded row reach (<= 15) + 1
# rows from each neighbour; megarsp's K15 the PSF's rows (<= 31), with the
# reference's R = 32 (kernels/tvr.py:388-391); sweepsp's K16 the stencil's 1
_HALO = {"megasp": 16, "megarsp": 32, "sweepsp": 1}


def _flat(v) -> list:
    """The tensors of a shard tuple or grid, in mesh order."""
    return [t for e in v for t in _flat(e)] if isinstance(v, tuple) else [v]


def _field(outs, k: int) -> tuple:
    """Entry ``k`` of each position's kernel result (a :class:`Remote`
    position stays one)."""
    return tuple(o if isinstance(o, Remote) else o[k] for o in outs)


def _positions(mesh: Mesh, fn) -> tuple:
    """``fn(i, device)`` (a 2-D mesh: ``fn(i, j, device)``) for each of this
    process's positions, a :class:`Remote` for the others: a tuple over a
    1-D mesh, a grid (a tuple of row tuples) over a 2-D one."""
    me, n1 = mesh.process_index, mesh.shape[-1]

    def at(p):
        if mesh.ranks[p] != me:
            return Remote(mesh.ranks[p])
        return fn(*(divmod(p, n1) if len(mesh.shape) == 2 else (p,)), mesh.devices[p])

    flat = [at(p) for p in range(mesh.size)]
    return tuple(flat) if len(mesh.shape) == 1 else tuple(tuple(flat[i : i + n1]) for i in range(0, mesh.size, n1))


def _local_devices(mesh: Mesh) -> list:
    """The devices of this process's positions, each once, in mesh order."""
    return list(dict.fromkeys(mesh.devices[p] for p in mesh.local_positions))


def _rel_blocks(old, new) -> torch.Tensor:
    """The relative improvement ``||new - old|| / ||old||`` of a sharded
    variable, its sums added over the shards on the first shard's device."""
    o = _flat(old)
    d = each(lambda a, b: b - a, o, _flat(new))
    return _rel_from_sums(pdot(d, d), pdot(o, o))


def _on_each(t: torch.Tensor, devices) -> dict:
    """One copy of ``t`` on each device, keyed by the copy's device."""
    out = {}
    for d in devices:
        c = t.to(d)
        out[c.device] = c
    return out


def _pds_prox(x, z, grad, adjz, gu_fn, tau, sigma, rho, lam, nonneg, iso):
    """The chain's Condat-Vu update on every shard: ``x_temp`` from the data
    gradient ``grad`` and ``K^H z`` (``adjz``), the dual from
    ``gu_fn(2 x_temp - x)`` (``K u``), both relaxed by ``rho``."""
    x_temp = each(lambda xi, g, a: xi - tau * g - tau * a, x, grad, adjz)
    if nonneg:
        x_temp = each(lambda t: torch.clamp(t, min=0.0), x_temp)
    ku = gu_fn(each(lambda t, xi: 2.0 * t - xi, x_temp, x))

    def dual(zi, k):
        v = zi + sigma * k
        if iso:
            mag = torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))
            zt = v * (lam / torch.clamp(mag, min=lam))
        else:
            zt = torch.clamp(v, -lam, lam)
        return rho * zt + (1 - rho) * zi

    return each(lambda t, xi: rho * t + (1 - rho) * xi, x_temp, x), each(dual, z, ku)


def _tau(beta: float, tau) -> float:
    """The reference's automatic step ``tau = sigma`` from the data term's
    Lipschitz constant ``beta`` and ``||grad|| <= sqrt(8)``."""
    if tau is not None:
        return float(tau)
    L_K = math.sqrt(8.0)
    return (1.0 / L_K**2) * (-beta / 4 + math.sqrt(beta**2 / 16 + L_K**2))


def _fft_beta(filt_np: np.ndarray, H: int, W: int) -> float:
    """``2 ||A||^2`` from the FFT padded to ``(H + m0 - 1, W + m1 - 1)``,
    the reference's closed form."""
    m0, m1 = filt_np.shape
    Hf = np.fft.fftn(filt_np.astype(np.float64), s=(H + m0 - 1, W + m1 - 1), axes=(0, 1))
    return 2.0 * float(np.max(np.abs(Hf))) ** 2


class _BlockedTV(IterativeSolver):
    """What the sharded TV solvers share: the ``use_pallas`` check, the
    metric from the kernels' partial sums (``_stats``) or, on the chain,
    from the shards' sums, the iterand joined on the first mesh device
    (each solver's ``_scatter`` and ``_gather``) and the TV term of the
    objective."""

    @staticmethod
    def _check_use_pallas(use_pallas, on_cuda: bool) -> bool:
        """Whether the fused engines run: ``"auto"`` on a CUDA mesh, ``True``
        and ``"interpret"`` (their plain versions on a CPU mesh); ``False``
        and ``"auto"`` on CPU devices take the chain."""
        if use_pallas not in ("auto", True, False, "interpret"):
            raise ValueError(f"use_pallas must be 'auto', True, False or 'interpret', not {use_pallas!r}")
        if on_cuda and use_pallas == "interpret":
            raise ValueError("use_pallas='interpret' runs the kernels' plain versions on a mesh of CPU "
                             "devices; on CUDA devices use 'auto'")
        if not on_cuda and use_pallas is True:
            raise ValueError("use_pallas=True launches the CUDA kernels but the mesh holds CPU devices; "
                             "pass use_pallas='interpret' for CPU meshes")
        return use_pallas in (True, "interpret") or (use_pallas == "auto" and on_cuda)

    def metric(self, old, new):
        """The relative improvement of x, from the kernels' partial sums or
        the shards' sums."""
        if "_stats" not in new:
            return _rel_blocks(old["x"], new["x"])
        st = new["_stats"]
        return _rel_from_sums(st[0], st[1])

    def metrics(self, old, new):
        if "_stats" not in new:
            return {k: _rel_blocks(old[k], new[k]) for k in self.diagnostics_vars(old)}
        st = new["_stats"]
        return {"x": _rel_from_sums(st[0], st[1]), "z0": _rel_from_sums(st[2], st[3]),
                "z1": _rel_from_sums(st[4], st[5])}

    def postprocess(self, state):
        """The user-facing iterand, each sharded variable joined into one
        tensor on the first local mesh device (on every process)."""
        return {k: self._gather(v) if isinstance(v, tuple) else v
                for k, v in super().postprocess(state).items()}

    def run(self, n_iters: int, x=None, z=None):
        """``n_iters`` iterations from ``x`` (H, W) and ``z`` (2, H, W) (zero
        by default); returns ``(x, z)`` joined on the first local mesh
        device."""
        state = self.initial_state()
        dev0 = self.mesh.local_device
        if x is not None:
            state["x"] = self._scatter(as_tensor(x, dev0))
        if z is not None:
            z = as_tensor(z, dev0)
            if "z" in state:
                state["z"] = self._scatter(z)
            else:
                state["z0"], state["z1"] = self._scatter(z[0]), self._scatter(z[1])
        state = self.run_fixed(n_iters, state=state)
        if "z" in state:
            return self._gather(state["x"]), self._gather(state["z"])
        return self._gather(state["x"]), torch.stack([self._gather(state["z0"]), self._gather(state["z1"])])

    def _tv_blocks(self, grads) -> list:
        """Each block's TV term from its (2, h, w) gradient."""
        if self.iso:
            return each(lambda g: torch.sum(torch.sqrt(g[0] * g[0] + g[1] * g[1])), grads)
        return each(lambda g: torch.sum(g[0].abs()) + torch.sum(g[1].abs()), grads)


class DistributedTVDeconv2D(_BlockedTV):
    r"""Condat-Vu PDS for ``min_x ||h * x - y||^2 + lam ||grad x||_{2,1}
    (+ nonnegativity)`` on an image row-sharded over a 1-D device mesh, or
    with ``mask=`` (and ``filt=None``) the diagonal-Gram sampling mode,
    ``y`` the back-projected data; the reference's mathematics, constructor
    and automatic steps (``tau = sigma`` from ``||A||`` over the FFT padded
    to ``(H + m0 - 1, W + m1 - 1)`` and ``||grad|| <= sqrt(8)``).

    Engines (``_sp_engine``), each one shard kernel launch per shard and
    iteration, in this order of preference:

    * ``"megasp"``: a rank-1 PSF within :func:`~pycsou_tpu_torch.opt.tv.rank1_gate`
      with ``h_loc >= 2 m0 - 2`` (the image-edge corrections stay on the
      first and last shard) and ``h_loc >= 16``: K14;
    * ``"megarsp"``: else a PSF of rank <= 4 within 31 taps per axis with
      ``h_loc >= 32``: K15;
    * ``"sweepsp"``: else, and in mask mode, the data gradient in PyTorch
      (``_data_grad``: the band Gram of a rank-1 PSF, else the fused FFT
      Gram with ``h_loc >= m0``, else the FFT forward and adjoint; mask mode
      ``2 (m x - atb)``), then K16 with one halo row.

    ``use_pallas``: ``"auto"`` or ``True`` runs these on a CUDA mesh;
    ``"interpret"`` runs the same engine on a mesh of CPU devices through the
    kernels' plain versions.  ``use_pallas=False``, and ``"auto"`` on CPU
    devices, step the reference's chain (``_sp_engine == ""``): the same
    data gradient, then the finite differences and the prox in PyTorch on
    every shard, with the state ``{"x", "z"}``.  The reference's TPU tile
    gates (``W % 128``, ``W >= 384``, an 8-, 16- or 32-row tile dividing
    ``h_loc``, the Mosaic budget of ``_pick_sweepsp_rows``) are not copied:
    the Hopper kernels tile any shard, so sweepsp takes every PSF and shard
    that megasp and megarsp leave.  A mesh of more than one axis, or a
    height that does not divide over the mesh, raises ``ValueError``; so
    does a shard shorter than the PSF's halo (the reference's check).

    ``A^H y`` is K1's adjoint on each shard grown by ``m0 - 1`` rows for
    megasp and megarsp, else the overlap-save FFT adjoint
    (``sharded_conv2d_adjoint``), as in the reference.  The state's ``x``,
    ``z0`` and ``z1`` (or ``z``) are tuples of shards on the mesh's devices
    (a ``Remote`` for a position of another process);
    :meth:`postprocess` (the result of ``solve()``) joins them on the first
    local mesh device.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.parallel import DistributedTVDeconv2D, make_mesh
        >>> mesh = make_mesh((4,), ("sp",), devices=[dev] * 4)  # four row shards of one device
        >>> H = 8 * len(mesh.devices)
        >>> y = torch.zeros(H, 16, device=dev)
        >>> y[H // 2, 8] = 1.0
        >>> solver = DistributedTVDeconv2D((H, 16), torch.ones(3, 3) / 9.0, y, lam=0.01, mesh=mesh,
        ...                                max_iter=50, min_iter=5, accuracy_threshold=1e-4)
        >>> info = solver.solve()   # the state stays cut into row shards
        >>> tuple(info["x"].shape) == (H, 16) and info.n_iter > 0
        True
    """

    def __init__(
        self,
        shape,
        filt,
        y,
        lam: float,
        nonneg: bool = True,
        mesh: Optional[Mesh] = None,
        axis_name: str = "sp",
        tau: Optional[float] = None,
        rho: float = 0.9,
        dtype=torch.float32,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        use_pallas="auto",
        isotropic: bool = True,
        mask=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        if dtype != torch.float32:
            raise ValueError("the shard kernels take float32")
        self.iso = bool(isotropic)
        H, W = as_shape(shape)
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(axis_name,))
        if len(self.mesh.axis_names) != 1:
            raise ValueError(
                f"DistributedTVDeconv2D shards rows over a 1-D mesh; got axes {self.mesh.axis_names} "
                "(use BatchedDistributedTVDeconv2D / Spatial2DTVDeconv2D for 2-D meshes)"
            )
        self.axis_name = self.mesh.axis_names[0]
        self.devices = self.mesh.devices
        n = len(self.devices)
        if H % n:
            raise ValueError(f"image height {H} must divide over {n} devices")
        kinds = {d.type for d in _local_devices(self.mesh)}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(f"the mesh must hold CUDA devices or CPU devices, got {self.devices}")
        self.shape = (H, W)
        self.h_loc = h = H // n
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.rho = float(rho)
        fused = self._check_use_pallas(use_pallas, kinds == {"cuda"})

        dev0 = self.mesh.local_device
        y = as_tensor(y, dev0)
        if tuple(y.shape) != (H, W):
            raise ValueError(f"y has shape {tuple(y.shape)}, expected {(H, W)}")
        self.y = self._scatter(y)
        self.mask = None
        self._grams = self._atb_ext = None
        self._use_band = self._use_gram = False
        self._sp_engine = ""
        if mask is not None:
            # the diagonal-Gram (sampling) mode: y is the back-projection
            # A^H y, the gradient 2 (mask x - atb) elementwise per shard
            if filt is not None:
                raise ValueError("mask mode models a diagonal sampling forward operator; pass filt=None")
            m = as_tensor(mask, dev0)
            if tuple(m.shape) != (H, W):
                raise ValueError(f"mask shape {tuple(m.shape)} != image shape {(H, W)}")
            self.filt = None
            self.beta = 2.0 * float(torch.max(m))
            self.mask = self._scatter(m)
            self.atb = self.y
            if fused:
                self._sp_engine = "sweepsp"
        else:
            filt_np = (filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt))
            filt_np = filt_np.astype(np.float32)
            m0, m1 = filt_np.shape
            # the widest halo the overlap-save convolutions take from one
            # neighbour (the reference's check)
            min_rows = max(1, m0 // 2, m0 - 1 - m0 // 2)
            if h < min_rows:
                raise ValueError(
                    f"local block of {h} rows is too short for a {m0}-row kernel: need at least "
                    f"{min_rows} rows per device (H={H} over {n} devices; use fewer devices or a taller image)"
                )
            self.beta = _fft_beta(filt_np, H, W)
            self.filt = as_tensor(filt_np, dev0)
            self._setup_chain(filt_np)
            if fused:
                self._sp_engine = self._conv_engine(filt_np)
            if self._sp_engine in ("megasp", "megarsp"):
                # A^H y per shard: K1's adjoint on the shard's y grown by
                # m0 - 1 rows of its neighbours (zeros beyond the image), cropped
                self.atb = tuple(each(lambda e, d: sepconv2d(e, self._grams[d].adj)[m0 - 1 : m0 - 1 + h],
                                      halo_extend(self.y, m0 - 1), self.devices))
                self._atb_ext = tuple(halo_extend(self.atb, _HALO[self._sp_engine]))
            else:
                self.atb = sharded_conv2d_adjoint(self.y, self.filt, self._h_hat_adj)
        self.tau = self.sigma = _tau(self.beta, tau)
        self._sp_r = _HALO.get(self._sp_engine, 0)

    # -- construction ------------------------------------------------------
    def _setup_chain(self, filt_np: np.ndarray) -> None:
        """The data gradient's routes (the reference's ``_use_band`` and
        ``_use_gram``) and their transfers and band plans, one copy a
        device."""
        (H, W), h, (m0, m1) = self.shape, self.h_loc, filt_np.shape
        devs = _local_devices(self.mesh)
        f = torch.flip(self.filt, (0, 1))
        self._h_hat_fwd = _on_each(conv_transfer(self.filt, (h + m0 - 1, W)), devs)
        self._h_hat_adj = _on_each(conv_transfer(f, (h + m0 - 1, W)), devs)
        acorr = conv_full_direct(self.filt, f)
        self._acorr_hat = _on_each(conv_transfer(acorr, (h + 2 * (m0 - 1), W)), devs)
        self._use_gram = h >= m0  # the Gram's frame strips need a block >= the kernel
        fac = lowrank_factors(filt_np)
        self._use_band = (fac is not None and fac[0].shape[1] == 1 and H >= 3 * m0 and W >= 3 * m1
                          and h >= max(m0 - 1, 2 * m0 - 2))  # the halo and the edge window
        if self._use_band:
            def plan(taps, n):
                acorr_t, Et, Eb, L = make_gram_band(taps, n)
                cast = lambda a: None if a is None else as_tensor(np.asarray(a, np.float32), self.filt.device)  # noqa: E731
                return cast(acorr_t), cast(Et), cast(Eb), L

            self._band_rows, self._band_cols = plan(fac[0][:, 0], H), plan(fac[1][:, 0], W)

    def _conv_engine(self, filt_np: np.ndarray) -> str:
        """megasp, else megarsp, by the reference's mathematical gates, for a
        band PSF; else sweepsp over the sharded Gram."""
        h, m0 = self.h_loc, filt_np.shape[0]
        dev0 = self.mesh.local_device
        convs = {d: Convolve2D(self.shape, filt_np, device=d) for d in _local_devices(self.mesh)}
        if convs[dev0].method != "band":
            return "sweepsp"
        # the Gram on each device: its rank-1 plan (K14) and factor taps (K1, K15)
        self._grams = {d: c.gram for d, c in convs.items()}
        if rank1_gate(self._grams[dev0]) is None and h >= 2 * m0 - 2 and h >= _HALO["megasp"]:
            return "megasp"
        if h >= _HALO["megarsp"]:
            return "megarsp"
        self._grams = None
        return "sweepsp"

    # -- shards ------------------------------------------------------------
    def _scatter(self, a: torch.Tensor):
        """The (..., H, W) tensor ``a`` as row shards on the mesh's devices."""
        h = self.h_loc
        return _positions(self.mesh, lambda i, d: a[..., i * h : (i + 1) * h, :].to(d).contiguous())

    def _gather(self, shards) -> torch.Tensor:
        """The shards joined along their rows on the first local mesh
        device (the other processes' gathered first)."""
        dev0 = self.mesh.local_device
        return torch.cat([s.to(dev0) for s in gather_positions(shards)], dim=-2)

    # -- IterativeSolver protocol -----------------------------------------
    def initial_state(self):
        zeros = lambda *lead: _positions(  # noqa: E731
            self.mesh, lambda i, d: torch.zeros(lead + (self.h_loc, self.shape[1]), device=d))
        if not self._sp_engine:
            return {"x": zeros(), "z": zeros(2)}
        return {"x": zeros(), "z0": zeros(), "z1": zeros(),
                "_stats": torch.zeros(6, device=self.mesh.local_device)}

    def _data_grad(self, x, atb, y) -> list:
        """Each shard's data gradient ``2 (A^H A x - A^H y)``: the band Gram
        of a rank-1 PSF, else the fused FFT Gram, else the FFT forward and
        adjoint (``2 A^H (A x - y)``); mask mode ``2 (m x - atb)``."""
        if self.mask is not None:
            return each(lambda m, xi, a: 2.0 * (m * xi - a), self.mask, x, atb)
        if self._use_band:
            g = sharded_sepgram_rank1(x, self._band_rows, self._band_cols)
        elif self._use_gram:
            g = sharded_conv2d_gram(x, self.filt, self._acorr_hat)
        else:
            r = each(lambda a, b: a - b, sharded_conv2d(x, self.filt, self._h_hat_fwd), y)
            return each(lambda t: 2.0 * t, sharded_conv2d_adjoint(r, self.filt, self._h_hat_adj))
        return each(lambda gi, a: 2.0 * (gi - a), g, atb)

    def _local_step(self, x, z, atb, y):
        """One iteration of the chain on every shard of one image: ``(x, z)``
        sequences of ``(h_loc, W)`` and ``(2, h_loc, W)`` shards, given its
        ``atb`` and ``y`` shards, to the new pair."""
        return _pds_prox(x, z, self._data_grad(x, atb, y), sharded_grad2d_adjoint(z), sharded_grad2d,
                         self.tau, self.sigma, self.rho, self.lam, self.nonneg, self.iso)

    def step(self, state):
        """One iteration: the chain, or each shard's halos then its shard
        kernel, in mesh order; the partial sums added over the shards in
        that order."""
        engine = self._sp_engine
        if not engine:
            xn, zn = self._local_step(state["x"], state["z"], self.atb, self.y)
            return {"x": tuple(xn), "z": tuple(zn)}
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        R, h = self._sp_r, self.h_loc
        kw = dict(H_global=self.shape[0], tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam,
                  nonneg=self.nonneg, iso=self.iso)

        outs = []
        if engine == "sweepsp":
            g = tuple(self._data_grad(x, self.atb, self.y))
            for i, hl in enumerate(halos((x, g, z0, z1), R)):
                outs.append(hl if isinstance(hl, Remote) else
                            tv_pds_sweep_shard_step(x[i], g[i], z0[i], z1[i], hl, i * h - R, **kw))
        else:
            for i, (hl, d) in enumerate(zip(halos((x, z0, z1), R), self.devices)):
                if isinstance(hl, Remote):
                    outs.append(hl)
                    continue
                gram, a = self._grams[d], self._atb_ext[i]
                if engine == "megasp":
                    o = tv_pds_mega2_shard_step(x[i], z0[i], z1[i], a, hl, gram, i * h - R, **kw)
                else:
                    o = tv_pds_megar_shard_step(x[i], z0[i], z1[i], a, hl, gram.fwd, gram.adj2, i * h - R,
                                                **kw)
                outs.append(o)
        return {"x": _field(outs, 0), "z0": _field(outs, 1), "z1": _field(outs, 2), "_stats": fold(_field(outs, 3))}

    # -- the reference's attribute API -------------------------------------
    @property
    def x0(self):
        """The initial (zero) primal iterand, as shards."""
        return self.initial_state()["x"]

    @property
    def z0(self):
        """The initial (zero) dual iterand, as (2, h_loc, W) shards."""
        init = self.initial_state()
        if "z" in init:
            return init["z"]
        return tuple(each(lambda a, b: torch.stack([a, b]), init["z0"], init["z1"]))

    def objective(self, x) -> torch.Tensor:
        """``||h * x - y||^2 + lam TV(x)`` (mask mode: observed pixels only,
        as ``TVDeconvolution.objective``) from ``x`` as shards (or one
        tensor, cut into shards): the overlap-save FFT convolution and the
        sharded gradient on each shard, the sums added in mesh order on the
        first local mesh device.  No host read."""
        if not isinstance(x, tuple):
            x = self._scatter(as_tensor(x, self.mesh.local_device))
        if self.mask is not None:
            data = fold(each(lambda m, xi, a: torch.sum(m * (xi - a / torch.clamp(m, min=1.0)) ** 2),
                             self.mask, x, self.atb))
        else:
            r = each(lambda a, b: a - b, sharded_conv2d(x, self.filt, self._h_hat_fwd), self.y)
            data = pdot(r, r)
        return data + self.lam * fold(self._tv_blocks(sharded_grad2d(x)))


class BatchedDistributedTVDeconv2D(_BlockedTV):
    r"""Batched TV deconvolution on a 2-D ``(dp, sp)`` mesh: a batch of B
    images is cut over ``dp`` (``B / dp`` images a mesh row) and each image
    into row shards over ``sp``; the reference's
    ``BatchedDistributedTVDeconv2D``.  Each mesh row steps its images, one
    after the other, on the chain of a :class:`DistributedTVDeconv2D` built
    with ``use_pallas=False`` on that row's devices (``_local_step``, the
    halos along ``sp``); there is no exchange along ``dp``.

    ``y`` is ``(B, H, W)``.  The state's ``x`` and ``z`` are grids: ``n_dp``
    row tuples of ``n_sp`` bricks, ``(B / dp, h_loc, W)`` and ``(B / dp, 2,
    h_loc, W)``, brick ``(i, j)`` on mesh device ``(i, j)``;
    :meth:`postprocess` joins them into ``(B, H, W)`` and ``(B, 2, H, W)`` on
    the first mesh device.  The metric is the relative improvement of the
    whole batch's ``x``."""

    def __init__(
        self,
        shape,
        filt,
        y,
        lam: float,
        nonneg: bool = True,
        mesh: Optional[Mesh] = None,
        tau: Optional[float] = None,
        rho: float = 0.9,
        dtype=torch.float32,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        isotropic: bool = True,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        self.mesh = mesh if mesh is not None else make_mesh((1, len(make_mesh().devices)), ("dp", "sp"))
        if len(self.mesh.axis_names) != 2:
            raise ValueError("mesh must be 2-D (dp, sp)")
        self.dp, self.sp = self.mesh.axis_names
        n_dp, n_sp = self.mesh.shape
        self.devices = self.mesh.devices
        y = as_tensor(y, self.mesh.local_device)
        if y.ndim != 3:
            raise ValueError("y must be (batch, H, W)")
        B = y.shape[0]
        H, W = as_shape(shape)
        if B % n_dp or H % n_sp:
            raise ValueError(f"batch {B} must divide over {n_dp} and height {H} over {n_sp}")
        self.batch, self.shape = B, (H, W)
        self.b_loc = B // n_dp
        # one per-image chain a mesh row that holds a position of this
        # process (None for another process's rows): its transfers and band
        # plans live on that row's devices
        ranks, me = self.mesh.ranks, self.mesh.process_index

        def inner(i):
            row = slice(i * n_sp, (i + 1) * n_sp)
            if me not in ranks[row]:
                return None
            sub = Mesh(self.devices[row], (self.sp,), ranks=ranks[row])
            return DistributedTVDeconv2D(
                (H, W), filt, torch.zeros((H, W), device=sub.local_device), lam, nonneg=nonneg, mesh=sub,
                tau=tau, rho=rho, dtype=dtype, max_iter=max_iter, use_pallas=False, isotropic=isotropic,
            )

        self._inners = tuple(inner(i) for i in range(n_dp))
        first = next(t for t in self._inners if t is not None)
        self.tau, self.sigma, self.rho, self.lam, self.iso = first.tau, first.sigma, first.rho, first.lam, first.iso
        self.y = self._scatter(y)

        # A^H y of each image, by its mesh row's sharded adjoint
        def adjoint(i, k):
            inner = self._inners[i]
            return (sharded_conv2d_adjoint(self._image(self.y, i, k), inner.filt, inner._h_hat_adj),)

        (self.atb,) = self._per_image(adjoint)

    # -- bricks ------------------------------------------------------------
    def _scatter(self, a: torch.Tensor):
        """The (B, ..., H, W) tensor ``a`` as the grid of bricks."""
        b, h = self.b_loc, self.shape[0] // self.mesh.shape[1]
        return _positions(self.mesh,
                          lambda i, j, d: a[i * b : (i + 1) * b, ..., j * h : (j + 1) * h, :].to(d).contiguous())

    def _gather(self, grid) -> torch.Tensor:
        """The bricks joined into one tensor on the first local mesh device
        (the other processes' gathered first)."""
        dev0 = self.mesh.local_device
        n_sp = self.mesh.shape[1]
        flat = [b.to(dev0) for b in gather_positions(_flat(grid))]
        return torch.cat([torch.cat(flat[i : i + n_sp], dim=-2) for i in range(0, len(flat), n_sp)])

    @staticmethod
    def _image(grid, i: int, k: int) -> list:
        """Image ``k`` of mesh row ``i``'s bricks: its row shards."""
        return each(lambda brick: brick[k], grid[i])

    def _per_image(self, fn) -> tuple:
        """``fn(i, k)``, a tuple of per-shard sequences for image ``k`` of
        mesh row ``i``, over every image of the rows this process holds a
        position of; each result's shards stacked back into a grid of
        bricks (a :class:`Remote` for another process's positions)."""
        n_sp = self.mesh.shape[1]
        rows = [None if t is None else [fn(i, k) for k in range(self.b_loc)] for i, t in enumerate(self._inners)]
        n_out = len(next(r for r in rows if r is not None)[0])

        def bricks(i, r):
            if rows[i] is None:
                return tuple(Remote(self.mesh.ranks[i * n_sp + j]) for j in range(n_sp))
            per = rows[i]
            return tuple(each(lambda *imgs: torch.stack(imgs), *[res[r] for res in per]))

        return tuple(tuple(bricks(i, r) for i in range(len(rows))) for r in range(n_out))

    # -- IterativeSolver protocol -----------------------------------------
    def initial_state(self):
        h, W = self.shape[0] // self.mesh.shape[1], self.shape[1]

        def zeros(*mid):
            return _positions(self.mesh, lambda i, j, d: torch.zeros((self.b_loc,) + mid + (h, W), device=d))

        return {"x": zeros(), "z": zeros(2)}

    def step(self, state):
        """One iteration of every image's chain, mesh row by mesh row."""
        def image(i, k):
            return self._inners[i]._local_step(*(self._image(state[v], i, k) for v in ("x", "z")),
                                               self._image(self.atb, i, k), self._image(self.y, i, k))

        x, z = self._per_image(image)
        return {"x": x, "z": z}

    def run(self, n_iters: int, x=None, z=None):
        """``n_iters`` iterations from ``x`` (B, H, W) and ``z`` (B, 2, H, W)
        (zero by default); returns ``(x, z)`` joined on the first local
        mesh device."""
        state = self.initial_state()
        dev0 = self.mesh.local_device
        if x is not None:
            state["x"] = self._scatter(as_tensor(x, dev0))
        if z is not None:
            state["z"] = self._scatter(as_tensor(z, dev0))
        state = self.run_fixed(n_iters, state=state)
        return self._gather(state["x"]), self._gather(state["z"])



class Spatial2DTVDeconv2D(_BlockedTV):
    r"""Condat-Vu PDS for ``min_x ||h * x - y||^2 + lam ||grad x||_{2,1}
    (+ nonnegativity)`` on ONE image cut into a grid of blocks over a 2-D
    ``(sp0, sp1)`` mesh: rows over ``sp0``, columns over ``sp1``; the
    reference's mathematics, constructor, checks and automatic steps (``tau
    = sigma`` from ``||A||`` over the FFT padded to ``(H + m0 - 1, W + m1 -
    1)`` and ``||grad|| <= sqrt(8)``), or with ``mask=`` (and ``filt=None``)
    the diagonal-Gram sampling mode.  The PSF must have rank <= 4
    (``ValueError`` otherwise, as in the reference).

    Engine ``"megar2d"``, one block kernel launch per block and iteration,
    in mesh order: with ``n1 > 1`` K17 on each block lane-extended by
    ``HALO_COLS`` (32) columns of its left and right neighbours, with row
    halos of R = 32 rows taken from the row neighbours' lane-extended blocks
    (their corners from the diagonal neighbours); with ``n1 == 1`` K15 on
    each block with R = 32 row halos (the reference's 1-D kernel path).
    ``A^H y`` is K1's adjoint on each block of ``y`` grown by ``m0 - 1`` rows
    and ``m1 - 1`` columns of its neighbours, cropped: no step gathers the
    image.  The six metric partial sums are added over the blocks, in mesh
    order, on the first mesh device.  It runs with ``use_pallas`` ``"auto"``
    or ``True`` on a CUDA mesh, ``"interpret"`` on a mesh of CPU devices
    (the kernels' plain versions), for a PSF of at most 31 taps an axis on
    blocks of at least 32 rows (and 32 columns when ``n1 > 1``).

    Else the reference's chain (``_sp_engine == ""``), state ``{"x",
    "z"}``: mask mode's gradient ``2 (m x - atb)``, or a rank-1 PSF's band
    Gram along both sharded axes (``sharded_sepgram_rank1_2d``, ``K - 1``
    halo rows and columns), then the sharded finite differences and the
    prox; there ``A^H y`` is the separable band adjoint
    (``sharded_sepconv2d_adjoint_2d``, summed over the ranks).  A rank > 1
    PSF that megar2d does not take raises ``ValueError``, as in the
    reference.  Deliberate differences from the reference: its TPU gates
    (``h_loc % 32``, ``w_loc % 128``, ``m1 <= 128``, ``w_loc >= 384``) are
    dropped, and its 128-lane column halo is 32 columns here;
    ``use_pallas=True`` on CPU devices raises ``ValueError``.

    The state's ``x``, ``z0`` and ``z1`` (``z``) are grids, tuples of ``n0``
    row tuples of ``n1`` ``(h_loc, w_loc)`` (``(2, h_loc, w_loc)``) blocks on
    the mesh's devices; :meth:`postprocess` (the result of ``solve()``)
    joins them on the first mesh device."""

    def __init__(
        self,
        shape,
        filt,
        y,
        lam: float,
        nonneg: bool = True,
        mesh: Optional[Mesh] = None,
        tau: Optional[float] = None,
        rho: float = 0.9,
        dtype=torch.float32,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        use_pallas="auto",
        isotropic: bool = True,
        mask=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        if dtype != torch.float32:
            raise ValueError("the block kernels take float32")
        self.iso = bool(isotropic)
        H, W = as_shape(shape)
        self.mesh = mesh if mesh is not None else make_mesh_2d()
        if len(self.mesh.axis_names) != 2:
            raise ValueError("Spatial2DTVDeconv2D needs a 2-D (rows, cols) mesh")
        self.ax_r, self.ax_c = self.mesh.axis_names
        n0, n1 = self.mesh.shape
        if H % n0 or W % n1:
            raise ValueError(f"image {H}x{W} must divide over the {n0}x{n1} mesh")
        self.devices = self.mesh.devices
        kinds = {d.type for d in _local_devices(self.mesh)}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(f"the mesh must hold CUDA devices or CPU devices, got {self.devices}")
        self.shape = (H, W)
        self.h_loc, self.w_loc = h_loc, w_loc = H // n0, W // n1
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.rho = float(rho)
        fused = self._check_use_pallas(use_pallas, kinds == {"cuda"})
        dev0 = self.mesh.local_device
        y = as_tensor(y, dev0)
        if tuple(y.shape) != (H, W):
            raise ValueError(f"y has shape {tuple(y.shape)}, expected {(H, W)}")
        self.y = self._scatter(y)
        self._sp_engine, self._sp_r = "", 0
        self.mask = self._band_rows = self._band_cols = self._rank_plans = None
        if mask is not None:
            # the diagonal-Gram (sampling) mode, on the chain only (the
            # reference has no 2-D mesh kernel for it)
            if filt is not None:
                raise ValueError("mask mode models a diagonal sampling forward operator; pass filt=None")
            m = as_tensor(mask, dev0)
            if tuple(m.shape) != (H, W):
                raise ValueError(f"mask shape {tuple(m.shape)} != image shape {(H, W)}")
            self.beta = 2.0 * float(torch.max(m))
            self.tau = self.sigma = _tau(self.beta, tau)
            self.mask = self._scatter(m)
            self.atb = self.y
            self.rank = 0
            return

        filt_np = (filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt))
        filt_np = filt_np.astype(np.float32)
        m0, m1 = filt_np.shape
        fac = lowrank_factors(filt_np)
        if fac is None:
            raise ValueError(
                "Spatial2DTVDeconv2D requires a rank <= 4 (sum-separable) PSF; use "
                "DistributedTVDeconv2D (1-D row sharding) otherwise"
            )
        self.rank = rank = fac[0].shape[1]
        need_r, need_c = max(m0 - 1, 2 * m0 - 2), max(m1 - 1, 2 * m1 - 2)
        if h_loc < need_r or w_loc < need_c or H < 3 * m0 or W < 3 * m1:
            raise ValueError(
                f"local blocks {h_loc}x{w_loc} too small for a {m0}x{m1} kernel: "
                f"need >= {need_r} rows and >= {need_c} cols per device"
            )
        self.beta = _fft_beta(filt_np, H, W)
        self.tau = self.sigma = _tau(self.beta, tau)
        # megar2d: the block kernels' taps and halos
        if (fused and max(m0, m1) <= MAX_TAPS and h_loc >= _HALO["megarsp"]
                and (n1 == 1 or w_loc >= HALO_COLS)):
            self._sp_engine, self._sp_r = "megar2d", _HALO["megarsp"]
        elif rank > 1:
            raise ValueError(
                f"rank-{rank} PSF on the 2-D mesh needs the fused megar2d engine (use_pallas on, taps "
                f"<= {MAX_TAPS} an axis, blocks of >= {_HALO['megarsp']} rows and, with columns cut, >= "
                f"{HALO_COLS} columns); this configuration does not qualify — use DistributedTVDeconv2D "
                "(1-D row sharding) instead"
            )
        us, vs = fac
        # per-rank separable plans, forward and adjoint (flipped taps at the
        # complementary offsets): the chain's A^H y and the objective's Gram
        t = lambda a: as_tensor(np.ascontiguousarray(a, np.float32), dev0)  # noqa: E731
        self._rank_plans = tuple(
            (((t(us[:, i]), m0 // 2), (t(vs[:, i]), m1 // 2)),
             ((t(us[::-1, i]), m0 - 1 - m0 // 2), (t(vs[::-1, i]), m1 - 1 - m1 // 2)))
            for i in range(rank))
        if rank == 1:
            def plan(taps, n):
                acorr_t, Et, Eb, L = make_gram_band(taps, n)
                cast = lambda a: None if a is None else t(a)  # noqa: E731
                return cast(acorr_t), cast(Et), cast(Eb), L

            self._band_rows, self._band_cols = plan(us[:, 0], H), plan(vs[:, 0], W)
        self._y2 = pdot(_flat(self.y), _flat(self.y))
        if not self._sp_engine:
            self.atb = self._sum_ranks(sharded_sepconv2d_adjoint_2d, self.y, 1)
            return

        # the factor taps on each device: forward (K1, K15, K17), adjoint
        # (A^H y), adjoint with the gradient's 2x (K15, K17)
        self._taps = {}
        for d in _local_devices(self.mesh):
            fwd = SepFactors(fac[0], fac[1], m0 // 2, m1 // 2, d)
            self._taps[d] = (fwd, fwd.adjoint(), fwd.adjoint(2.0))
        ext = halo_extend_2d(self.y, m0 - 1, m1 - 1)
        self.atb = self._grid(
            lambda i, j, d: sepconv2d(ext[i][j], self._taps[d][1])[m0 - 1 : m0 - 1 + h_loc,
                                                                    m1 - 1 : m1 - 1 + w_loc].contiguous())
        R = self._sp_r
        if n1 == 1:
            self._atb_ext = tuple((e,) for e in halo_extend([row[0] for row in self.atb], R))
        else:
            self._atb_ext = halo_extend_2d(self.atb, R, HALO_COLS)

    # -- blocks --------------------------------------------------------------
    def _grid(self, fn):
        """``fn(i, j, device)`` for each of this process's mesh positions, a
        :class:`Remote` for the others, as a grid."""
        return _positions(self.mesh, fn)

    def _scatter(self, a: torch.Tensor):
        """The (..., H, W) tensor ``a`` as a grid of blocks on the mesh's
        devices."""
        h, w = self.h_loc, self.w_loc
        return self._grid(lambda i, j, d: a[..., i * h : (i + 1) * h, j * w : (j + 1) * w].to(d).contiguous())

    def _gather(self, grid) -> torch.Tensor:
        """The blocks joined on the first local mesh device (the other
        processes' gathered first)."""
        dev0, n1 = self.mesh.local_device, self.mesh.shape[1]
        flat = [b.to(dev0) for b in gather_positions(_flat(grid))]
        return torch.cat([torch.cat(flat[i : i + n1], dim=-1) for i in range(0, len(flat), n1)], dim=-2)

    def _sum_ranks(self, fn, grid, which: int):
        """``fn(grid, rows_plan, cols_plan)`` summed over the ranks, with the
        forward (``which`` 0) or adjoint (1) plans."""
        out = None
        for plans in self._rank_plans:
            g = fn(grid, *plans[which])
            out = g if out is None else tuple(tuple(each(torch.add, ra, rb)) for ra, rb in zip(out, g))
        return out

    def _gram_local(self, grid):
        """``A^H A`` on the grid: the rank-1 band Gram, else the per-rank
        forward passes summed, then the per-rank adjoints summed (exact for
        any rank: each pass is an exact 'same' convolution)."""
        if self._band_rows is not None:
            return sharded_sepgram_rank1_2d(grid, self._band_rows, self._band_cols)
        return self._sum_ranks(sharded_sepconv2d_adjoint_2d,
                               self._sum_ranks(sharded_sepconv2d_2d, grid, 0), 1)

    # -- IterativeSolver protocol -----------------------------------------
    def initial_state(self):
        def zeros(*lead):
            return self._grid(lambda i, j, d: torch.zeros(lead + (self.h_loc, self.w_loc), device=d))

        if not self._sp_engine:
            return {"x": zeros(), "z": zeros(2)}
        return {"x": zeros(), "z0": zeros(), "z1": zeros(),
                "_stats": torch.zeros(6, device=self.mesh.local_device)}

    def _local_step(self, x, z):
        """One iteration of the chain on every block: grids ``(x, z)`` to the
        new pair."""
        if self.mask is not None:
            grad = each(lambda m, xi, a: 2.0 * (m * xi - a), _flat(self.mask), _flat(x), _flat(self.atb))
        else:
            grad = each(lambda g, a: 2.0 * (g - a),
                        _flat(sharded_sepgram_rank1_2d(x, self._band_rows, self._band_cols)), _flat(self.atb))
        n1 = self.mesh.shape[1]
        regrid = lambda flat: tuple(tuple(flat[i : i + n1]) for i in range(0, len(flat), n1))  # noqa: E731
        xn, zn = _pds_prox(_flat(x), _flat(z), grad, _flat(sharded_grad2d_adjoint_2d(z)),
                           lambda u: _flat(sharded_grad2d_2d(regrid(u))), self.tau, self.sigma, self.rho,
                           self.lam, self.nonneg, self.iso)
        return regrid(xn), regrid(zn)

    def step(self, state):
        """One iteration: the chain, or each block's halos then its block
        kernel, in mesh order; the partial sums added over the blocks in
        that order."""
        if not self._sp_engine:
            x, z = self._local_step(state["x"], state["z"])
            return {"x": x, "z": z}
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        R, (H, W), (h, w) = self._sp_r, self.shape, (self.h_loc, self.w_loc)
        kw = dict(H_global=H, tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam,
                  nonneg=self.nonneg, iso=self.iso)
        if self.mesh.shape[1] == 1:
            # columns not cut: the row-shard kernel K15, no lane extension
            hl = halos([[row[0] for row in a] for a in (x, z0, z1)], R)

            def block(i, j, d):
                fwd, _, adj2 = self._taps[d]
                return tv_pds_megar_shard_step(x[i][0], z0[i][0], z1[i][0], self._atb_ext[i][0], hl[i],
                                               fwd, adj2, i * h - R, **kw)
        else:
            ext = [lane_extend(a, HALO_COLS) for a in (x, z0, z1)]
            hl = halos_2d(ext, R)

            def block(i, j, d):
                fwd, _, adj2 = self._taps[d]
                return tv_pds_megar_shard2d_step(ext[0][i][j], ext[1][i][j], ext[2][i][j], self._atb_ext[i][j],
                                                 hl[i][j], fwd, adj2, (i * h - R, j * w - HALO_COLS),
                                                 W_global=W, **kw)

        outs = self._grid(block)
        return {**{k: tuple(_field(row, n) for row in outs) for n, k in enumerate(("x", "z0", "z1"))},
                "_stats": fold(_field([o for row in outs for o in row], 3))}

    def objective(self, x) -> torch.Tensor:
        """``||h * x - y||^2 + lam TV(x)`` (mask mode: observed pixels only)
        from ``x`` as a grid of blocks (or one tensor, cut into blocks): the
        data term by the Gram identity ``<x, A^H A x> - 2 <x, A^H y> +
        ||y||^2`` (:meth:`_gram_local`), the TV term from the sharded
        gradient, the sums added in mesh order on the first local mesh
        device.  No host read."""
        if not isinstance(x, tuple):
            x = self._scatter(as_tensor(x, self.mesh.local_device))
        xs = _flat(x)
        if self.mask is not None:
            data = fold(each(lambda m, xi, a: torch.sum(m * (xi - a / torch.clamp(m, min=1.0)) ** 2),
                             _flat(self.mask), xs, _flat(self.atb)))
        else:
            data = pdot(xs, _flat(self._gram_local(x))) - 2.0 * pdot(xs, _flat(self.atb)) + self._y2
        return data + self.lam * fold(self._tv_blocks(_flat(sharded_grad2d_2d(x))))
