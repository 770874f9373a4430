"""LASSO / sparse deconvolution by FISTA with the Gram, the prox and the
momentum fused into one kernel pass (counterpart of
``pycsou_tpu/opt/lasso.py``).

``LassoDeconvolution`` computes the iterates of ``APGD(F=SquaredL2Loss(y) *
Convolve2D(h), G=lam * L1Norm)``: the same BT, CD and None momentum rules and
the same automatic ``tau = 1/beta``.  Engines:

* ``"megaf"``: K8 (``kernels/fista.py``), one launch an iteration with the
  stopping-metric partial sums in its epilogue (5 image streams);
* ``"gram"``: the plain chain, the gradient through the operator's Gram
  (one K2 pass, ``grad_fused``, for a band PSF; else ``2 (A^H A v - atb)``
  through the grouped K1 sweeps of a rank 5-16 PSF or the FFT Gram
  ``ConvGram2D``, as in the reference), then the prox and the momentum.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pycsou_tpu_torch.core.solver import IterativeSolver, _rel_from_sums
from pycsou_tpu_torch.kernels.fista import lasso_fista_step
from pycsou_tpu_torch.ops.conv import Convolve2D, engine_conv
from pycsou_tpu_torch.utils.device import as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["LassoDeconvolution"]

ACCELERATIONS = ("BT", "CD", None)


def momentum(acceleration, d: float, t_old: torch.Tensor, n: torch.Tensor):
    """``(a, t)``: the extrapolation coefficient ``(t_old - 1) / t`` and the
    new ``t`` (0-d float32 tensors, computed on the state's device) of the
    BT, CD (``t = (n + d) / d``) or None (``a = 0``) rule."""
    if acceleration == "BT":
        t = (1 + torch.sqrt(1 + 4 * t_old**2)) / 2
    elif acceleration == "CD":
        t = (n.to(torch.float32) + d) / d
    else:
        t = t_old = torch.ones_like(t_old)
    return (t_old - 1) / t, t


class LassoDeconvolution(IterativeSolver):
    """``min_x ||A x - y||^2 + lam ||x||_1`` (or the nonnegative shrink
    when ``nonneg``) by FISTA; ``A`` a 2-D 'same' convolution, the identity
    when ``filt`` is None.  The device is ``device`` if given, else that of
    ``y``, else that of ``filt``.

    ``filt`` is the PSF (an array or tensor) or a
    :class:`~pycsou_tpu_torch.ops.conv.Convolve2D`.  An operator whose
    method ``'auto'`` chose, of domain ``shape``, on the solver's device is
    taken as it is: its taps, factors, Gram and norm bound ``lipschitz``
    (hence ``beta`` and the automatic ``tau``), with no second build;
    ``A^H y`` is still computed.  Any other operator (a forced method,
    another domain or device) is built again from its taps, as an array PSF
    is.

    ``use_pallas`` keeps the reference's switch: ``"auto"`` takes
    ``"megaf"`` on a CUDA device for any PSF of rank <= 4 within 31 taps per
    axis and ``"gram"`` otherwise; ``True`` asks for ``"megaf"`` and raises
    without CUDA or for another PSF; ``"interpret"`` runs ``"megaf"`` through
    K8's plain version on a CPU device (the counterpart of the reference's
    interpret mode); ``False`` takes ``"gram"``.

    Example: sparse spike recovery::

        >>> import numpy as np, torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.ops import Convolve2D
        >>> from pycsou_tpu_torch.opt import LassoDeconvolution
        >>> x_true = torch.zeros(16, 16, device=dev); x_true[4, 5] = 2.0; x_true[10, 12] = 1.5
        >>> g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
        >>> h = np.outer(g, g).astype(np.float32); h /= h.sum()
        >>> y = Convolve2D((16, 16), h, device=dev)(x_true)
        >>> info = LassoDeconvolution((16, 16), y, lam=0.01, filt=h, max_iter=300).solve()
        >>> bool(abs(float(info["x_temp"][4, 5]) - 2.0) < 0.2)
        True
    """

    def __init__(
        self,
        shape,
        y,
        lam: float,
        filt=None,
        nonneg: bool = False,
        tau: Optional[float] = None,
        acceleration: Optional[str] = "CD",
        d: float = 75.0,
        use_pallas="auto",
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-4,
        verbose: Optional[int] = None,
        metric_every: int = 1,
        device=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold,
                         verbose=verbose, metric_every=metric_every)
        shape = as_shape(shape)
        if acceleration not in ACCELERATIONS:
            raise ValueError("acceleration must be 'BT', 'CD' or None")
        if use_pallas not in ("auto", True, False, "interpret"):
            raise ValueError(f"use_pallas must be 'auto', True, False or 'interpret', not {use_pallas!r}")
        dev = resolve_device(device, y, filt.device if isinstance(filt, Convolve2D) else filt)
        self.device = dev
        self.y = as_tensor(y, dev)
        if tuple(self.y.shape) != shape:
            raise ValueError(f"y has shape {tuple(self.y.shape)}, expected {shape}")
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.acceleration = acceleration
        self.d = float(d)
        if filt is None:
            filt = np.ones((1, 1), np.float32)
        A = engine_conv(shape, filt, dev)
        self.filt = A.filt
        self.gram = A.gram
        self.atb = A.adjoint(self.y)
        self.beta = 2.0 * A.lipschitz**2
        self.tau = float(tau) if tau is not None else 1.0 / self.beta
        # the stopping metric watches the feasible iterate
        self.primary_var = "x_temp"

        banded = A.method == "band"
        if use_pallas == "interpret" and dev.type != "cpu":
            raise ValueError(f"use_pallas='interpret' runs K8's plain version on CPU tensors; the device is {dev}")
        if use_pallas is True and (dev.type != "cuda" or not banded):
            raise ValueError(
                "use_pallas=True launches K8, which needs a CUDA device and a PSF of rank <= 4 "
                f"within 31 taps per axis (device {dev}, PSF {'eligible' if banded else 'not eligible'})"
            )
        if use_pallas == "auto":
            use_pallas = dev.type == "cuda"
        self.engine = "megaf" if use_pallas and banded else "gram"
        if self.engine == "megaf":
            self._adj2 = self.gram.adj2

    def _sharded_twin(self) -> "LassoDeconvolution":
        """The copy ``with_shardings`` steps: the ``"gram"`` engine in place
        of megaf (K8), as the reference's ``_without_pallas``
        (``pycsou_tpu/opt/lasso.py``) drops its fused FISTA kernel."""
        if self.engine != "megaf":
            return self
        return self.replace(engine="gram")

    def with_shardings(self, **shardings) -> "LassoDeconvolution":
        """The generic sharded copy (``IterativeSolver.with_shardings``) of
        :meth:`_sharded_twin`."""
        return IterativeSolver.with_shardings(self._sharded_twin(), **shardings)

    # -- iteration -----------------------------------------------------------
    def initial_state(self):
        z = torch.zeros(self.y.shape, dtype=torch.float32, device=self.device)
        state = {
            "x": z,
            "x_temp": z.clone(),
            "t": torch.ones((), dtype=torch.float32, device=self.device),
            "n": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        if self.engine == "megaf":
            state["_stats"] = torch.zeros(6, dtype=torch.float32, device=self.device)
        return state

    def step(self, state):
        v, xp, n = state["x"], state["x_temp"], state["n"]
        a, t = momentum(self.acceleration, self.d, state["t"], n)
        if self.engine == "megaf":
            x_n, v_n, stats = lasso_fista_step(
                v, xp, self.atb, a.reshape(1), self.gram.fwd, self._adj2,
                tau=self.tau, lam=self.lam, nonneg=self.nonneg,
            )
            return {"x": v_n, "x_temp": x_n, "t": t, "n": n + 1, "_stats": stats}
        gf = getattr(self.gram, "grad_fused", None)  # K2 for a band PSF
        g = gf(v, self.atb) if gf is not None else 2.0 * (self.gram.apply(v) - self.atb)
        u = v - self.tau * g
        thr = self.tau * self.lam
        if self.nonneg:
            x_n = torch.clamp(u - thr, min=0.0)
        else:
            x_n = torch.sign(u) * torch.clamp(u.abs() - thr, min=0.0)
        v_n = x_n + a * (x_n - xp)
        return {"x": v_n, "x_temp": x_n, "t": t, "n": n + 1}

    def objective(self, x):
        """``||A x - y||^2 + lam ||x||_1`` through the Gram identity
        ``<x, A^H A x> - 2 <x, A^H y> + ||y||^2``."""
        x = torch.as_tensor(x)
        quad = torch.sum(x * self.gram.apply(x)) - 2.0 * torch.sum(x * self.atb) + torch.sum(self.y * self.y)
        return quad + self.lam * torch.sum(x.abs())

    # -- metrics from K8's partial sums ---------------------------------------
    def metric(self, old, new):
        if "_stats" in new:
            st = new["_stats"]
            return _rel_from_sums(st[0], st[1])
        return super().metric(old, new)

    def metrics(self, old, new):
        if "_stats" in new:
            st = new["_stats"]
            return {"x": _rel_from_sums(st[2], st[3]), "x_temp": _rel_from_sums(st[0], st[1])}
        return super().metrics(old, new)
