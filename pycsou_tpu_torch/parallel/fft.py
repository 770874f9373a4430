"""The distributed 2-D FFT by pencil decomposition (counterpart of
``pycsou_tpu/parallel/fft.py``).

A row-sharded image's 2-D FFT is a local ``rfft`` along the columns of each
row block, an all-to-all that turns the row blocks into column pencils,
and a local ``fft`` along the rows of each pencil: each mesh position ends
up with a column pencil of the whole half-spectrum, on which a spectral
multiply needs no communication; the inverse mirrors it.  Where the
reference's ``lax.all_to_all`` runs inside ``shard_map``, here position j
receives column chunk j of every source block (copied where the two
devices of one process differ, sent by ``parallel.mesh.all_to_all`` where
another process holds the source), concatenated along the rows in source
order.  On a mesh that spans processes the functions take and return the
blocks of this process's positions (as ``NamedSharding.split`` gives
them), and the operator's ``apply`` gathers the output blocks so that
every process holds the whole image.

:class:`PencilCircularConv2D` is the distributed twin of
``ops.conv.CircularConvolve`` for 2-D images: its transfer is cut into the
same pencils, and ``apply``, ``adjoint``, ``gram`` and ``pinv`` take and
return whole tensors on the caller's device, one pencil round trip each.
The transforms are ``torch.fft``: the reference's are XLA's, not a Pallas
kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pycsou_tpu_torch.core.linop import LinearOperator
from pycsou_tpu_torch.parallel.mesh import Mesh, all_to_all, each, gather_positions, make_mesh
from pycsou_tpu_torch.utils.device import Remote, as_tensor, resolve_device
from pycsou_tpu_torch.utils.shapes import as_shape

__all__ = ["pencil_cols", "pencil_rfft2", "pencil_irfft2", "PencilCircularConv2D"]


def pencil_cols(W: int, n: int) -> int:
    """Columns a position holds of the (zero-padded) half-spectrum pencil."""
    return -(-(W // 2 + 1) // n)


def _local(entries) -> tuple:
    return tuple(e for e in entries if not isinstance(e, Remote))


def pencil_rfft2(blocks: Sequence[torch.Tensor], mesh: Mesh) -> tuple:
    """The 2-D real FFT of a row-sharded image: ``blocks`` the ``(H / n,
    W)`` row blocks of this process's positions in mesh order (every
    position's on a mesh within one process), each on its position's
    device; returns the ``(H, wl)`` complex column pencils of the
    half-spectrum of the same positions (``wl = pencil_cols(W, n)``;
    columns past ``W // 2 + 1`` are zeros)."""
    blocks = mesh.place(blocks)
    n = len(blocks)
    W = _local(blocks)[0].shape[1]
    wl = pencil_cols(W, n)
    X = each(lambda b: torch.fft.rfft(b, dim=1), blocks)
    X = each(lambda x: F.pad(x, (0, n * wl - x.shape[1])), X)
    chunks = each(lambda x: [x[:, j * wl : (j + 1) * wl] for j in range(n)], X)
    return _local(each(lambda got: torch.fft.fft(torch.cat(got), dim=0), all_to_all(chunks, mesh.devices)))


def pencil_irfft2(pencils: Sequence[torch.Tensor], mesh: Mesh, W: int) -> tuple:
    """The inverse of :func:`pencil_rfft2`: column pencils to the ``(H / n,
    W)`` real row blocks (of this process's positions)."""
    pencils = mesh.place(pencils)
    n = len(pencils)
    hl = _local(pencils)[0].shape[0] // n
    Y = each(lambda p: torch.fft.ifft(p, dim=0), pencils)
    chunks = each(lambda y: [y[i * hl : (i + 1) * hl] for i in range(n)], Y)
    Wf = W // 2 + 1
    return _local(each(lambda got: torch.fft.irfft(torch.cat(got, dim=1)[:, :Wf], n=W, dim=1),
                       all_to_all(chunks, mesh.devices)))


class PencilCircularConv2D(LinearOperator):
    """Circular 2-D convolution of a row-sharded image by pencil FFTs:
    ``F^H diag(H) F``, the twin of ``ops.conv.CircularConvolve`` (the
    filter zero-padded, rolled by ``-(k // 2)`` and ``rfft2``'d, or
    ``h_hat`` given in the ``rfft2`` layout).  The transfer's column pencils
    live on the positions along the mesh axis ``axis``; ``H`` must divide
    over them (``ValueError``).  ``lipschitz = max |H|``.

    Example::

        >>> import numpy as np, torch
        >>> from pycsou_tpu_torch.parallel import PencilCircularConv2D, make_mesh
        >>> op = PencilCircularConv2D((8, 8), np.ones((1, 1)), mesh=make_mesh((4,), devices=["cpu"] * 4))
        >>> bool(torch.allclose(op(torch.arange(64.0).reshape(8, 8)), torch.arange(64.0).reshape(8, 8), atol=1e-4))
        True
    """

    def __init__(self, dim_shape: Tuple[int, int], filt=None, h_hat=None, mesh: Optional[Mesh] = None,
                 axis: str = "sp", dtype=torch.float32):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 2:
            raise ValueError("PencilCircularConv2D is 2-D; use CircularConvolve for other ranks")
        H, W = dim_shape
        mesh = mesh if mesh is not None else make_mesh(axis_names=(axis,))
        n = mesh.axis_size(axis)
        if H % n:
            raise ValueError(f"rows {H} must divide over {n} devices")
        positions = mesh.axis_positions(axis)
        devs = tuple(mesh.devices[p] for p in positions)
        self._sub = Mesh(devs, (axis,), ranks=[mesh.ranks[p] for p in positions])
        dev0 = self._sub.local_device
        if h_hat is None:
            if filt is None:
                raise ValueError("pass filt or h_hat")
            f = as_tensor(filt, resolve_device(None, filt, dev0))
            hfull = F.pad(f, (0, W - f.shape[1], 0, H - f.shape[0]))
            hfull = torch.roll(hfull, (-(f.shape[0] // 2), -(f.shape[1] // 2)), dims=(0, 1))
            h_hat = torch.fft.rfft2(hfull)
        else:
            h_hat = as_tensor(h_hat, resolve_device(None, h_hat, dev0), torch.complex64)
            if tuple(h_hat.shape) != (H, W // 2 + 1):
                raise ValueError(f"h_hat must have the rfft2 shape {(H, W // 2 + 1)}, got {tuple(h_hat.shape)}")
        hh = h_hat.detach().cpu().numpy()
        # the reference's max |H| from the float32 parts
        super().__init__(dim_shape, dim_shape, lipschitz=float(np.max(np.hypot(hh.real, hh.imag))), dtype=dtype)
        wl = pencil_cols(W, n)
        h_hat = F.pad(h_hat, (0, n * wl - h_hat.shape[1]))
        local = self._sub.local_positions
        self.h_pencils = tuple(h_hat[:, j * wl : (j + 1) * wl].to(devs[j]).contiguous() for j in local)
        self.h2_pencils = tuple((h * torch.conj(h)).real for h in self.h_pencils)
        self.mesh, self.axis = mesh, axis
        self._devices = devs

    @property
    def device(self):
        return self._sub.local_device

    def _spectral(self, x, fn):
        """``x`` (whole, on the caller's device) through the pencil FFT, the
        spectral map ``fn(pencil, k)`` on each of this process's pencils
        (the k-th), and back; the other processes' output blocks gathered."""
        x = torch.as_tensor(x)
        H, W = self.dim_shape
        n = len(self._devices)
        h = H // n
        local = self._sub.local_positions
        blocks = [x[i * h : (i + 1) * h].to(self._devices[i], non_blocking=True) for i in local]
        spec = pencil_rfft2(blocks, self._sub)
        out = self._sub.place(pencil_irfft2([fn(s, k) for k, s in enumerate(spec)], self._sub, W))
        out = each(lambda b: b.to(x.device, non_blocking=True), out)
        return torch.cat(gather_positions(out)).to(self.dtype)

    def apply(self, x):
        return self._spectral(x, lambda S, j: S * self.h_pencils[j])

    def adjoint(self, y):
        return self._spectral(y, lambda S, j: S * torch.conj(self.h_pencils[j]))

    @property
    def gram(self) -> LinearOperator:
        """``A^H A``: the ``|H|^2`` pencil multiply, one round trip."""
        return _PencilCircGram(self)

    def pinv(self, y, damp: float = 0.0, **kwargs):
        """The (damped) Fourier inverse ``conj(H) Y / max(|H|^2 + damp,
        1e-30)``, one round trip (``CircularConvolve.pinv``)."""
        d = float(damp)
        return self._spectral(
            y, lambda S, j: S * torch.conj(self.h_pencils[j])
            / torch.clamp(torch.abs(self.h_pencils[j]) ** 2 + d, min=1e-30))


class _PencilCircGram(LinearOperator):
    """``A^H A`` of :class:`PencilCircularConv2D`."""

    def __init__(self, op: PencilCircularConv2D):
        super().__init__(op.dim_shape, op.dim_shape, lipschitz=op.lipschitz**2, dtype=op.dtype)
        self.op = op

    @property
    def device(self):
        return self.op.device

    def apply(self, x):
        return self.op._spectral(x, lambda S, j: S * self.op.h2_pencils[j])

    def adjoint(self, y):
        return self.apply(y)
