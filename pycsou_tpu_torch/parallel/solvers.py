"""Sharded TV deconvolution on a mesh of devices (counterpart of
``pycsou_tpu/parallel/solvers.py`` ``DistributedTVDeconv2D`` and
``Spatial2DTVDeconv2D``).

The image, the data and the duals are cut into row shards over a 1-D
:class:`~pycsou_tpu_torch.parallel.mesh.Mesh`; one PDS iteration takes each
shard's neighbour halos (``parallel/spatial.py``) and launches one fused
shard kernel per shard, in mesh order, as the reference's ``shard_map``
runs its per-shard Pallas kernel on every device.  The six metric partial
sums are added over the shards on the first mesh device (the reference's
``psum``).  The state is a dict of per-shard tuples (``x``, ``z0``, ``z1``)
and ``_stats``, so ``IterativeSolver``'s metric, histories and ``solve()``
apply unchanged.

:class:`Spatial2DTVDeconv2D` cuts the image into a grid of blocks over a 2-D
``(sp0, sp1)`` mesh and runs one fused block kernel per block (K17, or K15
when the columns are not cut); its state holds a tuple of row tuples of
blocks.

``BatchedDistributedTVDeconv2D``, the XLA-chain engines, conv-mode sweepsp,
the 2-D mesh's mask mode and meshes across processes are not ported yet
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.kernels.conv2d import MAX_TAPS, SepFactors, sepconv2d
from pycsou_tpu_torch.kernels.tv import tv_pds_mega2_shard_step, tv_pds_sweep_shard_step
from pycsou_tpu_torch.kernels.tvr import HALO_COLS, tv_pds_megar_shard2d_step, tv_pds_megar_shard_step
from pycsou_tpu_torch.ops.conv import Convolve2D, lowrank_factors
from pycsou_tpu_torch.ops.diff import fdiff_forward
from pycsou_tpu_torch.opt.tv import rank1_gate
from pycsou_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from pycsou_tpu_torch.parallel.spatial import halo_extend, halo_extend_2d, halos, halos_2d, lane_extend
from pycsou_tpu_torch.utils.device import as_tensor
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["DistributedTVDeconv2D", "Spatial2DTVDeconv2D"]

# halo rows per engine: megasp's K14 reads the padded row reach (<= 15) + 1
# rows from each neighbour; megarsp's K15 the PSF's rows (<= 31), with the
# reference's R = 32 (kernels/tvr.py:388-391); sweepsp's K16 the stencil's 1
_HALO = {"megasp": 16, "megarsp": 32, "sweepsp": 1}
_UNPORTED = "(ROADMAP Queue 1 item 8)"


class _BlockedTV(IterativeSolver):
    """What the sharded TV solvers share: the ``use_pallas`` check, the
    metric from the kernels' partial sums (``_stats``), the iterand joined
    on the first mesh device (each solver's ``_scatter`` and ``_gather``)
    and the TV term of the objective."""

    @staticmethod
    def _check_use_pallas(use_pallas, on_cuda: bool) -> None:
        if use_pallas not in ("auto", True, False, "interpret"):
            raise ValueError(f"use_pallas must be 'auto', True, False or 'interpret', not {use_pallas!r}")
        chain = ("the reference's XLA chain (sharded FFT and band Grams), which is not ported yet "
                 f"{_UNPORTED}")
        if use_pallas is False:
            raise NotImplementedError(f"use_pallas=False selects {chain}")
        if on_cuda and use_pallas == "interpret":
            raise ValueError("use_pallas='interpret' runs the kernels' plain versions on a mesh of CPU "
                             "devices; on CUDA devices use 'auto'")
        if not on_cuda and use_pallas is True:
            raise ValueError("use_pallas=True launches the CUDA kernels but the mesh holds CPU devices; "
                             "pass use_pallas='interpret' for CPU meshes")
        if not on_cuda and use_pallas == "auto":
            raise NotImplementedError(
                f"use_pallas='auto' on CPU devices selects {chain}; use_pallas='interpret' runs the fused "
                "engines' plain versions on CPU devices"
            )

    def metric(self, old, new):
        """The relative improvement of x from the kernels' partial sums."""
        st = new["_stats"]
        return _rel_from_sums(st[0], st[1])

    def metrics(self, old, new):
        st = new["_stats"]
        return {"x": _rel_from_sums(st[0], st[1]), "z0": _rel_from_sums(st[2], st[3]),
                "z1": _rel_from_sums(st[4], st[5])}

    def postprocess(self, state):
        """The user-facing iterand, each sharded variable joined into one
        tensor on the first mesh device."""
        return {k: self._gather(v) if isinstance(v, tuple) else v
                for k, v in super().postprocess(state).items()}

    def run(self, n_iters: int, x=None, z=None):
        """``n_iters`` iterations from ``x`` (H, W) and ``z`` (2, H, W) (zero
        by default); returns ``(x, z)`` joined on the first mesh device."""
        state = self.initial_state()
        dev0 = self.devices[0]
        if x is not None:
            state["x"] = self._scatter(as_tensor(x, dev0))
        if z is not None:
            z = as_tensor(z, dev0)
            state["z0"], state["z1"] = self._scatter(z[0]), self._scatter(z[1])
        state = self.run_fixed(n_iters, state=state)
        return self._gather(state["x"]), torch.stack([self._gather(state["z0"]), self._gather(state["z1"])])

    def _tv(self, x: torch.Tensor) -> torch.Tensor:
        g0, g1 = fdiff_forward(x, 0), fdiff_forward(x, 1)
        return torch.sum(torch.sqrt(g0 * g0 + g1 * g1)) if self.iso else torch.sum(g0.abs()) + torch.sum(g1.abs())


class DistributedTVDeconv2D(_BlockedTV):
    r"""Condat-Vu PDS for ``min_x ||h * x - y||^2 + lam ||grad x||_{2,1}
    (+ nonnegativity)`` on an image row-sharded over a 1-D device mesh, or
    with ``mask=`` (and ``filt=None``) the diagonal-Gram sampling mode,
    ``y`` the back-projected data; the reference's mathematics, constructor
    and automatic steps (``tau = sigma`` from ``||A||`` over the FFT padded
    to ``(H + m0 - 1, W + m1 - 1)`` and ``||grad|| <= sqrt(8)``).

    Engines (``_sp_engine``), each one shard kernel launch per shard and
    iteration:

    * ``"megasp"``: a rank-1 PSF within :func:`~pycsou_tpu_torch.opt.tv.rank1_gate`
      with ``h_loc >= 2 m0 - 2`` (the image-edge corrections stay on the
      first and last shard) and ``h_loc >= 16``: K14;
    * ``"megarsp"``: else a PSF of rank <= 4 within 31 taps per axis with
      ``h_loc >= 32``: K15;
    * ``"sweepsp"``: mask mode, the gradient ``2 (m x - atb)`` in PyTorch,
      then K16.

    ``use_pallas``: ``"auto"`` or ``True`` runs these on a CUDA mesh;
    ``"interpret"`` runs the same engine on a mesh of CPU devices through the
    kernels' plain versions.  The reference's TPU tile gates (``W % 128``,
    ``W >= 384``, an 8-, 16- or 32-row tile dividing ``h_loc``, the Mosaic
    budget of ``_pick_sweepsp_rows``) are not copied: the Hopper kernels
    tile any shard.  A case the port cannot run raises
    ``NotImplementedError``: ``use_pallas=False`` and ``"auto"`` on the CPU
    (the reference's XLA chain), a PSF no fused engine takes (full rank,
    rank > 4, more than 31 taps, or shards too short), conv-mode sweepsp.
    A mesh of more than one axis, or a height that does not divide over the
    mesh, raises ``ValueError``.

    The state's ``x``, ``z0`` and ``z1`` are tuples of ``(h_loc, W)`` shards
    on the mesh's devices; :meth:`postprocess` (the result of ``solve()``)
    joins them on the first mesh device."""

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
                f"(a (rows, cols) mesh of one image: Spatial2DTVDeconv2D; the dp x sp mesh of "
                f"BatchedDistributedTVDeconv2D is not ported yet {_UNPORTED})"
            )
        self.axis_name = self.mesh.axis_names[0]
        self.devices = self.mesh.devices
        n = len(self.devices)
        if H % n:
            raise ValueError(f"image height {H} must divide over {n} devices")
        kinds = {d.type for d in self.devices}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(f"the mesh must hold CUDA devices or CPU devices, got {self.devices}")
        self.shape = (H, W)
        self.h_loc = H // n
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.rho = float(rho)
        self._check_use_pallas(use_pallas, kinds == {"cuda"})

        dev0 = self.devices[0]
        y = as_tensor(y, dev0)
        if tuple(y.shape) != (H, W):
            raise ValueError(f"y has shape {tuple(y.shape)}, expected {(H, W)}")
        self.y = self._scatter(y)
        L_K = math.sqrt(8.0)
        self.mask = None
        self._grams = self._atb_ext = None
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
            self._sp_engine = "sweepsp"
        else:
            filt_np = (filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt))
            filt_np = filt_np.astype(np.float32)
            m0, m1 = filt_np.shape
            # ||A|| over the FFT padded to (H + m0 - 1, W + m1 - 1), the
            # reference's closed form (its Convolve2D pads to fast lengths)
            Hf = np.fft.fftn(filt_np.astype(np.float64), s=(H + m0 - 1, W + m1 - 1), axes=(0, 1))
            self.beta = 2.0 * float(np.max(np.abs(Hf))) ** 2
            self.filt = as_tensor(filt_np, dev0)
            convs = {d: Convolve2D((H, W), filt_np, device=d) for d in dict.fromkeys(self.devices)}
            if convs[dev0].method != "band":
                raise NotImplementedError(
                    "no fused shard engine takes this PSF (megasp: rank 1, megarsp: rank <= 4 within 31 "
                    f"taps per axis); the reference's XLA chain for it is not ported yet {_UNPORTED}"
                )
            # the Gram on each device: its rank-1 plan (K14) and factor taps (K1, K15)
            self._grams = {d: c.gram for d, c in convs.items()}
            self._sp_engine = self._conv_engine(self._grams[dev0], m0)
            # A^H y per shard: K1's adjoint on the shard's y grown by m0 - 1
            # rows of its neighbours (zeros beyond the image), cropped
            self.atb = tuple(
                sepconv2d(e, self._grams[d].adj)[m0 - 1 : m0 - 1 + self.h_loc]
                for d, e in zip(self.devices, halo_extend(self.y, m0 - 1))
            )
            self._atb_ext = tuple(halo_extend(self.atb, _HALO[self._sp_engine]))
        if tau is None:
            b = self.beta
            tau = (1.0 / L_K**2) * (-b / 4 + math.sqrt(b**2 / 16 + L_K**2))
        self.tau = self.sigma = float(tau)
        self._sp_r = _HALO[self._sp_engine]

    # -- construction ------------------------------------------------------
    def _conv_engine(self, gram, m0: int) -> str:
        """megasp, else megarsp, by the reference's mathematical gates."""
        h = self.h_loc
        if rank1_gate(gram) is None and h >= 2 * m0 - 2 and h >= _HALO["megasp"]:
            return "megasp"
        if h >= _HALO["megarsp"]:
            return "megarsp"
        raise NotImplementedError(
            f"shards of {h} rows are too short for the fused shard engines (megasp needs >= "
            f"{max(2 * m0 - 2, _HALO['megasp'])} rows and a rank-1 PSF, megarsp >= {_HALO['megarsp']}); "
            f"the reference's sweepsp over the sharded Gram is not ported yet {_UNPORTED}"
        )

    # -- shards ------------------------------------------------------------
    def _scatter(self, a: torch.Tensor):
        """The (H, ...) tensor ``a`` as row shards on the mesh's devices."""
        h = self.h_loc
        return tuple(a[i * h : (i + 1) * h].to(d).contiguous() for i, d in enumerate(self.devices))

    def _gather(self, shards) -> torch.Tensor:
        """The shards joined on the first mesh device."""
        return torch.cat([s.to(self.devices[0]) for s in shards])

    # -- IterativeSolver protocol -----------------------------------------
    def initial_state(self):
        zeros = lambda: tuple(torch.zeros((self.h_loc, self.shape[1]), device=d)  # noqa: E731
                              for d in self.devices)
        return {"x": zeros(), "z0": zeros(), "z1": zeros(),
                "_stats": torch.zeros(6, device=self.devices[0])}

    def step(self, state):
        """One iteration: each shard's halos, then its shard kernel, in mesh
        order; the partial sums added over the shards in that order."""
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        R, h, engine = self._sp_r, self.h_loc, self._sp_engine
        kw = dict(H_global=self.shape[0], tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam,
                  nonneg=self.nonneg, iso=self.iso)

        outs = []
        if engine == "sweepsp":
            g = tuple(2.0 * (m * xi - a) for m, xi, a in zip(self.mask, x, self.atb))
            for i, hl in enumerate(halos((x, g, z0, z1), R)):
                outs.append(tv_pds_sweep_shard_step(x[i], g[i], z0[i], z1[i], hl, i * h - R, **kw))
        else:
            for i, (hl, d) in enumerate(zip(halos((x, z0, z1), R), self.devices)):
                gram, a = self._grams[d], self._atb_ext[i]
                if engine == "megasp":
                    o = tv_pds_mega2_shard_step(x[i], z0[i], z1[i], a, hl, gram, i * h - R, **kw)
                else:
                    o = tv_pds_megar_shard_step(x[i], z0[i], z1[i], a, hl, gram.fwd, gram.adj2, i * h - R,
                                                **kw)
                outs.append(o)
        stats = outs[0][3]
        for o in outs[1:]:
            stats = stats + o[3].to(stats.device)
        return {"x": tuple(o[0] for o in outs), "z0": tuple(o[1] for o in outs),
                "z1": tuple(o[2] for o in outs), "_stats": stats}

    # -- the reference's attribute API -------------------------------------
    @property
    def x0(self):
        """The initial (zero) primal iterand, as shards."""
        return self.initial_state()["x"]

    @property
    def z0(self):
        """The initial (zero) dual iterand, as (2, h_loc, W) shards."""
        init = self.initial_state()
        return tuple(torch.stack([a, b]) for a, b in zip(init["z0"], init["z1"]))

    def objective(self, x) -> torch.Tensor:
        """``||h * x - y||^2 + lam TV(x)`` (mask mode: observed pixels only,
        as ``TVDeconvolution.objective``), evaluated on the first mesh
        device: ``x`` (shards or one tensor) and the data are joined there,
        the blur is ``Convolve2D``'s (K1 on the card)."""
        dev0 = self.devices[0]
        x = self._gather(x) if isinstance(x, tuple) else as_tensor(x, dev0)
        tv = self._tv(x)
        if self.mask is not None:
            m = self._gather(self.mask)
            yc = self._gather(self.atb) / torch.clamp(m, min=1.0)
            return torch.sum(m * (x - yc) ** 2) + self.lam * tv
        r = sepconv2d(x, self._grams[dev0].fwd) - self._gather(self.y)
        return torch.sum(r * r) + self.lam * tv


class Spatial2DTVDeconv2D(_BlockedTV):
    r"""Condat-Vu PDS for ``min_x ||h * x - y||^2 + lam ||grad x||_{2,1}
    (+ nonnegativity)`` on ONE image cut into a grid of blocks over a 2-D
    ``(sp0, sp1)`` mesh: rows over ``sp0``, columns over ``sp1``; the
    reference's mathematics, constructor, checks and automatic steps (``tau
    = sigma`` from ``||A||`` over the FFT padded to ``(H + m0 - 1, W + m1 -
    1)`` and ``||grad|| <= sqrt(8)``).  The PSF must have rank <= 4
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
    order, on the first mesh device.

    ``use_pallas``: ``"auto"`` or ``True`` runs the engine on a CUDA mesh;
    ``"interpret"`` on a mesh of CPU devices through the kernels' plain
    versions.  Deliberate differences from the reference: its TPU gates
    (``h_loc % 32``, ``w_loc % 128``, ``m1 <= 128``, ``w_loc >= 384``) are
    dropped, and its 128-lane column halo is 32 columns here.  Raising:
    ``use_pallas=False`` and ``"auto"`` on CPU devices (the reference's
    banded XLA chain), mask mode (the reference runs only that chain there),
    a PSF of more than 31 taps an axis and blocks of fewer than 32 rows (or
    32 columns, ``n1 > 1``) raise ``NotImplementedError``; ``use_pallas=True``
    on CPU devices raises ``ValueError`` before the mode is looked at.

    The state's ``x``, ``z0`` and ``z1`` are grids, tuples of ``n0`` row
    tuples of ``n1`` ``(h_loc, w_loc)`` blocks on the mesh's devices;
    :meth:`postprocess` (the result of ``solve()``) joins them on the first
    mesh device."""

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
        kinds = {d.type for d in self.devices}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(f"the mesh must hold CUDA devices or CPU devices, got {self.devices}")
        self.shape = (H, W)
        self.h_loc, self.w_loc = H // n0, W // n1
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.rho = float(rho)
        self._check_use_pallas(use_pallas, kinds == {"cuda"})
        if mask is not None:
            if filt is not None:
                raise ValueError("mask mode models a diagonal sampling forward operator; pass filt=None")
            raise NotImplementedError(
                "Spatial2DTVDeconv2D's mask mode runs only the reference's XLA chain, which is not "
                f"ported yet {_UNPORTED}; DistributedTVDeconv2D(mask=...) runs it on a 1-D mesh"
            )

        filt_np = (filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt))
        filt_np = filt_np.astype(np.float32)
        m0, m1 = filt_np.shape
        fac = lowrank_factors(filt_np)
        if fac is None:
            raise ValueError(
                "Spatial2DTVDeconv2D requires a rank <= 4 (sum-separable) PSF; use "
                "DistributedTVDeconv2D (1-D row sharding) otherwise"
            )
        self.rank = fac[0].shape[1]
        h_loc, w_loc = self.h_loc, self.w_loc
        need_r, need_c = max(m0 - 1, 2 * m0 - 2), max(m1 - 1, 2 * m1 - 2)
        if h_loc < need_r or w_loc < need_c or H < 3 * m0 or W < 3 * m1:
            raise ValueError(
                f"local blocks {h_loc}x{w_loc} too small for a {m0}x{m1} kernel: "
                f"need >= {need_r} rows and >= {need_c} cols per device"
            )
        if max(m0, m1) > MAX_TAPS:
            raise NotImplementedError(
                f"a {m0}x{m1} PSF: the block kernels take at most {MAX_TAPS} taps an axis; the "
                f"reference's XLA chain for it is not ported yet {_UNPORTED}"
            )
        if h_loc < _HALO["megarsp"] or (n1 > 1 and w_loc < HALO_COLS):
            raise NotImplementedError(
                f"blocks of {h_loc}x{w_loc}: the block kernels take {_HALO['megarsp']} halo rows "
                f"(and {HALO_COLS} halo columns when the columns are cut) from each neighbour; the "
                f"reference's XLA chain for smaller blocks is not ported yet {_UNPORTED}"
            )
        Hf = np.fft.fftn(filt_np.astype(np.float64), s=(H + m0 - 1, W + m1 - 1), axes=(0, 1))
        self.beta = 2.0 * float(np.max(np.abs(Hf))) ** 2
        L_K = math.sqrt(8.0)
        if tau is None:
            b = self.beta
            tau = (1.0 / L_K**2) * (-b / 4 + math.sqrt(b**2 / 16 + L_K**2))
        self.tau = self.sigma = float(tau)
        self._sp_engine, self._sp_r = "megar2d", _HALO["megarsp"]

        dev0 = self.devices[0]
        # the factor taps on each device: forward (K1, K15, K17), adjoint
        # (A^H y), adjoint with the gradient's 2x (K15, K17)
        self._taps = {}
        for d in dict.fromkeys(self.devices):
            fwd = SepFactors(fac[0], fac[1], m0 // 2, m1 // 2, d)
            self._taps[d] = (fwd, fwd.adjoint(), fwd.adjoint(2.0))
        y = as_tensor(y, dev0)
        if tuple(y.shape) != (H, W):
            raise ValueError(f"y has shape {tuple(y.shape)}, expected {(H, W)}")
        self.y = self._scatter(y)
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
        """``fn(i, j, device)`` for each mesh position, as a grid."""
        n0, n1 = self.mesh.shape
        return tuple(tuple(fn(i, j, self.devices[i * n1 + j]) for j in range(n1)) for i in range(n0))

    def _scatter(self, a: torch.Tensor):
        """The (H, W) tensor ``a`` as a grid of blocks on the mesh's devices."""
        h, w = self.h_loc, self.w_loc
        return self._grid(lambda i, j, d: a[i * h : (i + 1) * h, j * w : (j + 1) * w].to(d).contiguous())

    def _gather(self, grid) -> torch.Tensor:
        """The blocks joined on the first mesh device."""
        dev0 = self.devices[0]
        return torch.cat([torch.cat([b.to(dev0) for b in row], dim=1) for row in grid])

    # -- IterativeSolver protocol -----------------------------------------
    def initial_state(self):
        zeros = lambda: self._grid(lambda i, j, d: torch.zeros((self.h_loc, self.w_loc), device=d))  # noqa: E731
        return {"x": zeros(), "z0": zeros(), "z1": zeros(),
                "_stats": torch.zeros(6, device=self.devices[0])}

    def step(self, state):
        """One iteration: each block's halos, then its block kernel, in mesh
        order; the partial sums added over the blocks in that order."""
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
        flat = [o for row in outs for o in row]
        stats = flat[0][3]
        for o in flat[1:]:
            stats = stats + o[3].to(stats.device)
        return {**{k: tuple(tuple(o[n] for o in row) for row in outs) for n, k in enumerate(("x", "z0", "z1"))},
                "_stats": stats}

    def objective(self, x) -> torch.Tensor:
        """``||h * x - y||^2 + lam TV(x)`` on the first mesh device: ``x`` (a
        grid of blocks or one tensor) and the data are joined there, the blur
        is K1 (its plain version on the CPU)."""
        dev0 = self.devices[0]
        x = self._gather(x) if isinstance(x, tuple) else as_tensor(x, dev0)
        r = sepconv2d(x, self._taps[dev0][0]) - self._gather(self.y)
        return torch.sum(r * r) + self.lam * self._tv(x)
