"""TV-regularised 2-D deconvolution, inpainting and super-resolution with
fused Condat-Vu iterations (counterpart of ``pycsou_tpu/opt/tv.py``
``TVDeconvolution``).

Three modes, as in the reference:

* **conv** (``filt`` given or None, no ``mask``): ``A`` a 'same'
  convolution, the identity when ``filt`` is None (denoising).
* **mask** (``mask`` given, no ``filt``): ``A`` a sampling operator whose
  Gram is the diagonal ``mask`` (the per-pixel sample count ``A^H 1``);
  ``y`` is the back-projection ``A^H y_obs``.  Denoising at >= 2**21 pixels
  runs here too, with an all-ones mask, as in the reference.
* **combined** (``filt`` and ``mask``): ``A = M o C``, blurred and sampled
  data; the Gram is ``C^H diag(mask) C`` and ``y`` is ``M^H y_obs``.

Engines (``stencil=``):

* conv: the reference's ladder, in its order: ``"mega3"`` (K10, two
  iterations per launch, ``iters_per_step = 2``), ``"mega2"`` (K11),
  ``"megar"`` (K4), ``"mega"`` (K12 after the column Gram ``w`` in
  PyTorch), ``"sweep"`` (the gradient, then K3) and ``"element"`` (the
  gradient, then K13 on a stacked dual).  The three rank-1 engines need
  :func:`rank1_gate`, megar a band PSF (rank <= 4 within 31 taps per
  axis); the CUDA ``"auto"`` is the first eligible engine
  (:func:`conv_engine`), sweep for every other PSF.  The gradient of sweep
  and element is one K2 pass for a band PSF, else ``2 (A^H A x - atb)``
  through the Gram (the reference's ``_grad``): the grouped K1 sweeps of a
  rank 5-16 PSF or the FFT Gram ``ConvGram2D``;
* mask: ``"sweepm2"`` (K6, two iterations per launch, ``iters_per_step =
  2``; the CUDA ``"auto"``) and ``"sweepm"`` (K5, one iteration);
* combined: ``"megarm"`` (K7; the CUDA ``"auto"`` for a band PSF) and
  ``"sweep"`` (the gradient ``2 (C^H (m C x) - atb)``, then K3; the CUDA
  ``"auto"`` for every other PSF, where the reference runs its XLA chain:
  the same iterates, through K3);
* every mode: ``"plain"``, the kernels' plain PyTorch versions one
  iteration a step, for CPU tensors only (``"auto"`` on the CPU).

``use_pallas`` and ``stencil="xla"`` are the reference's switches
(``pycsou_tpu/opt/tv.py:274-313``): ``"auto"`` and ``True`` keep the pick
above (``True`` on the CPU raises, as a CUDA engine named there does),
``False`` and ``stencil="xla"`` take ``"plain"``; ``"xla"`` wins over
``use_pallas``, and a CUDA engine named with ``use_pallas=False`` raises.
The plain engine runs on CPU tensors only, so on a card both raise,
naming ``device="cpu"``, where the reference runs its XLA stencil on any
backend: the port never runs the plain versions on the card.

In mask and combined modes the CUDA ``"auto"`` is the mode's first engine
for every shape (:func:`masked_engine`; sweep for a combined-mode PSF that
is not band), where the reference picks by its
TPU tile gates (``pycsou_tpu/opt/tv.py:314-373``): mask mode runs sweepm2
only when an 8-, 16- or 32-row tile within the Mosaic budget divides H into
at least two tiles, else sweepm with one tile, else its XLA chain; combined
mode runs megarm only with a megar plan (``W % 128 == 0``, ``W >= 384``,
``H % 8 == 0``), else its XLA chain.  The Hopper kernels tile any shape, so
the port keeps sweepm2 and megarm there.  Where the reference steps once and
the port twice a launch (sweepm or the XLA chain against sweepm2),
``run_fixed`` of an odd n runs n + 1 iterations here and n there, and
``solve()`` may stop at another iteration; at equal iteration counts the
iterates agree.

Every engine but ``mega`` and ``element`` emits the six metric partial
sums, so the stopping metric costs no extra pass; those two, as in the
reference, carry no ``_stats`` and take the generic metric.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.kernels.band import gram_band_cols
from pycsou_tpu_torch.kernels.conv2d import MAX_TAPS, sepgram2d
from pycsou_tpu_torch.kernels.tv import (
    R1_REACHES,
    tv_pds_mega2_step,
    tv_pds_mega3_step,
    tv_pds_mega_step,
    tv_pds_stencil_step,
    tv_pds_sweep_step_stats,
    tv_pds_sweep_step_stats_plain,
    tv_pds_sweepm2_step,
    tv_pds_sweepm_step_stats,
    tv_pds_sweepm_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tvr import (
    tv_pds_megar_step,
    tv_pds_megar_step_plain,
    tv_pds_megarm_step_plain,
)
from pycsou_tpu_torch.ops.conv import Convolve2D, SeparableConvGram2D, engine_conv
from pycsou_tpu_torch.ops.diff import fdiff_forward
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["TVDeconvolution", "band_gate", "conv_engine", "masked_engine", "rank1_gate"]

# each mode's CUDA engines in the order of the reference's ladder
MODE_ENGINES = {
    "conv": ("mega3", "mega2", "megar", "mega", "sweep", "element"),
    "mask": ("sweepm2", "sweepm"),
    "combined": ("megarm", "sweep"),
}
RANK1_ENGINES = ("mega3", "mega2", "mega")
_CUDA_ENGINES = tuple(dict.fromkeys(sum(MODE_ENGINES.values(), ())))
ENGINES = ("auto",) + _CUDA_ENGINES + ("plain",)
# engines whose kernels (or plain versions) emit the metric partial sums
_STATS_ENGINES = ("mega3", "mega2", "megar", "megarm", "sweep", "sweepm", "sweepm2", "plain")
_LARGE_DENOISE = 1 << 21  # pixels; the reference reroutes denoising past it
_ROW_REACH = 15  # the reference's rank-1 row reach (its 16-row Gram halo)


def rank1_gate(gram) -> Optional[str]:
    """None when the rank-1 engines take this Gram, else why not: the one
    source of the rank-1 gates, read by the TV ladder (mega3, mega2, mega:
    K10-K12) and by ``PMYULA``'s fused engine (K9), as the reference's
    ``mega3_plans`` is (``pycsou_tpu/opt/tv.py:48-89``).

    The reference's mathematical gates, kept: a rank-1 PSF with the rank-1
    plan of :class:`~pycsou_tpu_torch.ops.conv.SeparableConvGram2D` (``H >=
    3 m0``, ``W >= 3 m1``, ``2 (m - 1) <= 128``), a row reach ``K1 = m0 - 1
    <= 15``, a row edge window ``L_r = 2 m0 - 2 <= 32`` (implied by the
    reach) and ``2 K1c <= 128`` (implied by the column reach below).  Its TPU tile and VMEM gates (``H % 32``, ``W % 128``, ``W >=
    384``, the ``48 W 4 <= 820000`` Mosaic budget) are not copied: the
    Hopper kernels (``csrc/tvr1.cu``) tile any (H, W) with 32 x 32 tiles,
    the last tile of an axis shifted back onto the edge.  Their own
    requirement is a column reach ``K1c = m1 - 1 <= 15`` as well: the
    kernels are instantiated for reaches up to 15 (``R1_REACHES``), and
    K10's two stages at 32 x 32 tiles take 125 KB of shared memory at that
    reach.  So a rank-1 PSF of 17 to 31 columns runs megar here where the
    reference runs mega3."""
    if not isinstance(gram, SeparableConvGram2D) or gram.rank != 1:
        return "the PSF is not rank 1"
    m0, m1 = gram.fwd.Ku, gram.fwd.Kv
    if m0 - 1 > _ROW_REACH:  # also L_r = 2 m0 - 2 <= 32
        return f"{m0} row taps: the rank-1 engines take a row reach of at most {_ROW_REACH}"
    if m1 - 1 > R1_REACHES[-1]:  # also 2 K1c <= 128
        return f"{m1} column taps: the Hopper kernels take a column reach of at most {R1_REACHES[-1]}"
    if gram.g_meta is None:
        return f"the rank-1 plan needs H >= 3 m0 = {3 * m0} and W >= 3 m1 = {3 * m1}"
    return None


def band_gate(gram) -> Optional[str]:
    """None when the Gram is a band one (:class:`SeparableConvGram2D`: a
    PSF of rank <= 4 within 31 taps per axis, whose factors megar, megarm
    and K2 take), else why not."""
    if isinstance(gram, SeparableConvGram2D):
        return None
    return (f"the PSF's Gram is {type(gram).__name__}, not a band one (rank <= 4 within "
            f"{MAX_TAPS} taps per axis)")


def conv_engine(gram, stencil: str = "auto", device_type: str = "cuda") -> str:
    """The conv-mode engine a :class:`TVDeconvolution` of this Gram runs on
    a device of ``device_type``: ``"auto"`` is the first eligible engine of
    ``MODE_ENGINES["conv"]`` on CUDA (mega3 for a rank-1 PSF within
    :func:`rank1_gate`, else megar for a band PSF, else sweep) and
    ``"plain"`` on the CPU.  An explicit engine is returned when it applies
    and raises ``ValueError`` when it does not (another mode's engine, a
    rank-1 engine outside the gate, megar for a PSF that is not band, a
    CUDA engine on the CPU, ``"plain"`` on CUDA)."""
    engines = MODE_ENGINES["conv"]
    why = {e: rank1_gate(gram) for e in RANK1_ENGINES}
    why["megar"] = band_gate(gram)
    if stencil == "auto":
        if device_type != "cuda":
            return "plain"
        return next(e for e in engines if why.get(e) is None)
    if stencil != "plain" and stencil not in engines:
        raise ValueError(
            "conv mode supports stencil 'auto', " + ", ".join(repr(e) for e in engines)
            + f" or 'plain', not {stencil!r}"
        )
    if why.get(stencil) is not None:
        raise ValueError(f"stencil={stencil!r} is not eligible for this PSF and shape: {why[stencil]}")
    return _on_its_device(stencil, device_type)


def _on_its_device(stencil: str, device_type: str) -> str:
    """``stencil``, or ``ValueError`` when it does not run on ``device_type``
    (a CUDA engine on the CPU, ``"plain"`` on CUDA)."""
    if stencil in _CUDA_ENGINES and device_type != "cuda":
        raise ValueError(f"stencil={stencil!r} launches CUDA kernels; the solver's device is {device_type}")
    if stencil == "plain" and device_type != "cpu":
        raise ValueError(f"stencil='plain' (also use_pallas=False, stencil='xla') runs on CPU tensors only; the "
                         f'solver\'s device is {device_type}: pass device="cpu" for the plain engine')
    return stencil


def masked_engine(mode: str, stencil: str = "auto", device_type: str = "cuda", conv=None) -> str:
    """The engine a mask- or combined-mode :class:`TVDeconvolution` runs on a
    device of ``device_type``: ``"auto"`` is the mode's first CUDA engine
    (sweepm2, megarm) on CUDA for every shape (the module docstring says
    where the reference picks otherwise), sweep in combined mode when the
    convolution ``conv`` is not a band one, and ``"plain"`` on the CPU.  An
    explicit engine is returned when it applies and raises ``ValueError``
    when it does not (megarm for a PSF that is not band among them)."""
    band = conv is None or conv.method == "band"
    if stencil == "auto":
        if device_type != "cuda":
            return "plain"
        return MODE_ENGINES[mode][0 if band else 1]
    if stencil != "plain" and stencil not in MODE_ENGINES[mode]:
        raise ValueError(
            f"{mode} mode supports stencil 'auto', "
            + ", ".join(repr(e) for e in MODE_ENGINES[mode]) + f" or 'plain', not {stencil!r}"
        )
    if stencil == "megarm" and not band:
        raise ValueError(f"stencil='megarm' needs a PSF of rank <= 4 within {MAX_TAPS} taps per axis; "
                         f"this one takes Convolve2D method={conv.method!r}")
    return _on_its_device(stencil, device_type)


class TVDeconvolution(IterativeSolver):
    """``min_x ||A x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})`` by
    Condat-Vu PDS, ``A`` a 2-D 'same' convolution (the identity when
    ``filt`` is None), a sampling operator of diagonal Gram ``mask``, or
    both (see the module docstring).  ``isotropic=False`` takes the
    anisotropic ``lam ||grad x||_1``.  The device is ``device`` if given,
    else that of ``y``, else that of ``filt``.

    ``filt`` is the PSF (an array or tensor) or a
    :class:`~pycsou_tpu_torch.ops.conv.Convolve2D`.  An operator whose
    method ``'auto'`` chose, of domain ``shape``, on the solver's device is
    taken as it is: its taps, factors, Gram and norm bound ``lipschitz``
    (hence ``beta``), with no second build; ``A^H y`` is still computed.
    Any other operator (a forced method, another domain or device) is built
    again from its taps, as an array PSF is.

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.opt.tv import TVDeconvolution
        >>> x_true = torch.zeros(16, 16, device=dev)
        >>> x_true[4:12, 4:12] = 1.0
        >>> ij = torch.arange(16, device=dev)[:, None] + torch.arange(16, device=dev)[None, :]
        >>> y = x_true + 0.2 * (-1.0) ** ij      # checkerboard "noise"
        >>> solver = TVDeconvolution((16, 16), y, lam=0.3, nonneg=True, max_iter=300)
        >>> info = solver.solve()
        >>> bool(torch.linalg.norm(info["x"] - x_true) < 0.5 * torch.linalg.norm(y - x_true))
        True
    """

    def __init__(
        self,
        shape,
        y,
        lam: float,
        filt=None,
        nonneg: bool = True,
        tau: Optional[float] = None,
        sigma: Optional[float] = None,
        rho: float = 0.9,
        use_pallas="auto",
        stencil: str = "auto",
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        metric_every: int = 1,
        isotropic: bool = True,
        mask=None,
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold,
                         verbose=verbose, metric_every=metric_every)
        shape = as_shape(shape)
        if stencil not in ENGINES + ("xla",):
            raise ValueError(f"unknown stencil {stencil!r}; expected one of {ENGINES + ('xla',)}")
        if use_pallas not in ("auto", True, False):
            raise ValueError(f"use_pallas must be 'auto', True or False, not {use_pallas!r}")
        dev = resolve_device(device, y, filt.device if isinstance(filt, Convolve2D) else filt, mask)
        if stencil == "xla" or use_pallas is False:
            if stencil not in ("auto", "xla", "plain"):
                raise ValueError(f"stencil={stencil!r} launches CUDA kernels, but use_pallas=False asks for the "
                                 "plain engine")
            stencil = "plain"
        elif use_pallas is True and stencil == "auto" and dev.type != "cuda":
            raise ValueError(f"use_pallas=True launches CUDA kernels; the solver's device is {dev.type}")
        self.device = dev
        self.y = as_tensor(y, dev)
        if tuple(self.y.shape) != shape:
            raise ValueError(f"y has shape {tuple(self.y.shape)}, expected {shape}")
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.iso = bool(isotropic)
        self.rho = float(rho)

        self.filt = None  # the PSF (a 1x1 marker on the large-denoise reroute)
        self.mask = None
        self.conv = None  # combined mode's convolution
        self.gram = None  # conv mode's Gram
        if mask is None and filt is None and (
            stencil in MODE_ENGINES["mask"]
            or (stencil in ("auto", "plain") and shape[0] * shape[1] >= _LARGE_DENOISE)
        ):
            # large denoising (A = I) is the all-ones diagonal Gram: it runs
            # on the masked engines, as in the reference; the same problem
            # (atb = y, beta = 2, the same auto steps)
            mask = torch.ones(shape, dtype=torch.float32, device=dev)
            self.filt = torch.ones((1, 1), dtype=torch.float32, device=dev)
        if mask is not None:
            m = as_tensor(mask, dev)
            if tuple(m.shape) != shape:
                raise ValueError(f"mask shape {tuple(m.shape)} != image shape {shape}")
            self.mask = m
            m_max = float(torch.max(m))
        if mask is not None and filt is not None:
            mode = "combined"
            conv = engine_conv(shape, filt, dev)
            self.conv = conv
            self.filt = conv.filt
            self._adj2 = conv.fwd.adjoint(2.0) if conv.method == "band" else None
            self.atb = conv.adjoint(self.y)
            self.beta = 2.0 * m_max * conv.lipschitz**2
        elif mask is not None:
            mode = "mask"
            self.atb = self.y
            self.beta = 2.0 * m_max
        else:
            mode = "conv"
            if filt is None:
                # denoising as the identity 1x1 convolution: gram = I, atb = y
                filt = np.ones((1, 1), np.float32)
            conv = engine_conv(shape, filt, dev)
            self.filt = conv.filt
            self.gram = conv.gram
            self.atb = conv.adjoint(self.y)
            self.beta = 2.0 * conv.lipschitz**2
        self.mode = mode

        if mode == "conv":
            stencil = conv_engine(self.gram, stencil, dev.type)
        else:
            stencil = masked_engine(mode, stencil, dev.type, conv=self.conv)
        self.stencil_mode = stencil
        self.use_pallas = stencil != "plain"
        if stencil in ("sweepm2", "mega3"):
            self.iters_per_step = 2

        L_K = math.sqrt(8.0)
        if tau is None:
            b = self.beta
            tau = (1.0 / L_K**2) * (-b / 4 + math.sqrt(b**2 / 16 + L_K**2))
        self.tau = float(tau)
        self.sigma = float(tau) if sigma is None else float(sigma)

    def with_shardings(self, **shardings) -> "TVDeconvolution":
        """The generic sharded copy (``IterativeSolver.with_shardings``: the
        state whole on the mesh's first device) on the first single-step
        engine of its mode's ladder, one iteration a step, so that
        ``run_fixed(n)`` runs exactly n iterations for odd n too, as the
        reference's copy does.  The reference runs its XLA stencil there
        (``stencil_mode="xla"``); here conv mode runs mega2 (K11) for a
        rank-1 PSF within :func:`rank1_gate`, else megar (K4) for a band
        PSF, else sweep (K2 or the Gram, then K3); mask mode sweepm (K5);
        combined mode megarm (K7) for a band convolution, else sweep; CPU
        tensors ``"plain"``.  For the solve cut over the mesh use
        ``parallel.DistributedTVDeconv2D`` (or ``PDS.with_shardings``)."""
        out = super().with_shardings(**shardings)
        if self.device.type != "cuda":
            engine = "plain"
        elif self.mode == "conv":
            engine = "mega2" if rank1_gate(self.gram) is None else "megar" if band_gate(self.gram) is None \
                else "sweep"
        elif self.mode == "mask":
            engine = "sweepm"
        else:
            engine = "megarm" if self.conv.method == "band" else "sweep"
        return out.replace(stencil_mode=engine, iters_per_step=1)

    # -- iteration ---------------------------------------------------------
    def initial_state(self):
        z = lambda: torch.zeros(self.y.shape, dtype=torch.float32, device=self.device)  # noqa: E731
        state = {"x": z(), "z0": z(), "z1": z()}
        if self.stencil_mode in _STATS_ENGINES:
            state["_stats"] = torch.zeros(6, device=self.device)
        return state

    def _grad(self, x):
        """The data gradient ``2 (A^H A x - atb)`` of the sweep, element and
        plain engines: one K2 pass for a band PSF in conv mode, else the
        reference's ``_grad`` through the Gram (conv mode) or through ``C``,
        the mask and ``C^H`` (combined mode)."""
        if self.mode == "combined":
            return 2.0 * (self.conv.adjoint(self.mask * self.conv.apply(x)) - self.atb)
        g = self.gram
        if isinstance(g, SeparableConvGram2D):
            return sepgram2d(x, g.fwd, g.adj2, self.atb)
        return 2.0 * (g.apply(x) - self.atb)

    def _mega_colgram(self, x):
        """``w = ColGram(x)`` for K12: the column band pass with its edge
        corrections, in PyTorch at full f32 (the reference's XLA pass; K12
        applies the row direction and its corrections)."""
        return gram_band_cols(x, self.gram.band_plans()[1]).contiguous()

    def step(self, state):
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        kw = dict(tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam,
                  nonneg=self.nonneg, iso=self.iso)
        engine, m, atb = self.stencil_mode, self.mask, self.atb
        if self.mode == "conv":
            g = self.gram
            if engine in ("mega", "element"):
                # stacked duals and no partial sums, as in the reference
                z = torch.stack([z0, z1])
                if engine == "mega":
                    x, z = tv_pds_mega_step(x, z, self._mega_colgram(x), atb, g, **kw)
                else:
                    x, z = tv_pds_stencil_step(x, z, self._grad(x), **kw)
                return {"x": x, "z0": z[0], "z1": z[1]}
            if engine == "mega3":
                out = tv_pds_mega3_step(x, z0, z1, atb, g, **kw)
            elif engine == "mega2":
                out = tv_pds_mega2_step(x, z0, z1, atb, g, **kw)
            elif engine == "megar":
                out = tv_pds_megar_step(x, z0, z1, atb, g.fwd, g.adj2, **kw)
            elif engine == "sweep":
                out = tv_pds_sweep_step_stats(x, z0, z1, self._grad(x), **kw)
            elif isinstance(g, SeparableConvGram2D):
                out = tv_pds_megar_step_plain(x, z0, z1, atb, g.fwd, g.adj2, **kw)
            else:
                out = tv_pds_sweep_step_stats_plain(x, z0, z1, self._grad(x), **kw)
        elif self.mode == "mask":
            if engine == "sweepm2":
                out = tv_pds_sweepm2_step(x, z0, z1, m, atb, **kw)
            elif engine == "sweepm":
                out = tv_pds_sweepm_step_stats(x, z0, z1, m, atb, **kw)
            else:
                out = tv_pds_sweepm_step_stats_plain(x, z0, z1, m, atb, **kw)
        else:
            fwd, adj2 = self.conv.fwd, self._adj2
            if engine == "megarm":
                out = tv_pds_megar_step(x, z0, z1, atb, fwd, adj2, mask=m, **kw)
            elif engine == "sweep":
                out = tv_pds_sweep_step_stats(x, z0, z1, self._grad(x), **kw)
            elif fwd is not None:
                out = tv_pds_megarm_step_plain(x, z0, z1, m, atb, fwd, adj2, **kw)
            else:
                out = tv_pds_sweep_step_stats_plain(x, z0, z1, self._grad(x), **kw)
        x, z0, z1, stats = out
        return {"x": x, "z0": z0, "z1": z1, "_stats": stats}

    # -- metrics from the engines' partial sums ----------------------------
    def metric(self, old, new):
        """From the engine's partial sums; for the double-step engines
        (sweepm2, mega3) they measure the second iteration of the step only
        (the reference's convention).  Engines without them (mega, element)
        take the generic relative improvement of x."""
        if "_stats" not in new:
            return super().metric(old, new)
        st = new["_stats"]
        return _rel_from_sums(st[0], st[1])

    def metrics(self, old, new):
        if "_stats" not in new:
            return super().metrics(old, new)
        st = new["_stats"]
        return {
            "x": _rel_from_sums(st[0], st[1]),
            "z0": _rel_from_sums(st[2], st[3]),
            "z1": _rel_from_sums(st[4], st[5]),
        }

    def objective(self, x):
        """``||A x - y||^2 + lam TV(x)``.  Conv mode evaluates the data term
        through the Gram identity ``<x, A^H A x> - 2 <x, A^H y> + ||y||^2``;
        mask and combined modes score the observed pixels only,
        ``sum m (t - y / max(m, 1))^2`` with ``t = x`` or ``C x`` (exact for
        0/1 masks; for sample counts > 1 correct up to the constant spread
        of repeated observations, as in the reference)."""
        x = torch.as_tensor(x)
        if self.mode == "combined":
            yc = self.y / torch.clamp(self.mask, min=1.0)
            data = torch.sum(self.mask * (self.conv.apply(x) - yc) ** 2)
        elif self.mode == "mask":
            yc = self.atb / torch.clamp(self.mask, min=1.0)
            data = torch.sum(self.mask * (x - yc) ** 2)
        else:
            data = (torch.sum(x * self.gram.apply(x)) - 2.0 * torch.sum(x * self.atb)
                    + torch.sum(self.y * self.y))
        dx, dy = fdiff_forward(x, 0), fdiff_forward(x, 1)
        tv = torch.sum(torch.sqrt(dx**2 + dy**2)) if self.iso else torch.sum(dx.abs()) + torch.sum(dy.abs())
        return data + self.lam * tv
