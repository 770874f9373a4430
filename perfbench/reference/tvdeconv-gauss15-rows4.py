"""Plain reference of TV deconvolution on an image cut into row blocks, one
block a device, for a deployment whose image no single card holds.

The same mathematics as ``tvdeconv-gauss15.py`` and ``condat_vu.py`` (the
'same', zero-boundary convolution ``y[p] = sum_k h[k] x[p + m//2 - k]``,
Condat-Vu with the closed-form steps, the stopping metric ``||x_new - x||
/ ||x||``), computed block by block:

* ``x``, ``z0``, ``z1`` and ``A^H y`` are row blocks on the devices;
  before each data gradient every block takes ``m0 - 1`` rows of ``x``
  from each neighbour (zeros beyond the image), the finite differences one
  row of ``z0`` from the previous block and one of ``2 x' - x`` from the
  next;
* each convolution is a zero-padded FFT over a block's rows with their
  halo (overlap-save), cut into chunks of rows so that its transforms stay
  small: ``A x`` over the chunk's rows and the ``m0 - 1`` rows around them,
  cropped to the image, then ``A^H`` of that, as the whole-image
  reference's ``A^H (A x)``;
* ``||A|| <= max |DFT(h)|`` on the whole-image grid of ``tvdeconv-gauss15``
  (``fast_len(n + m - 1)`` a side), computed a block of columns at a time;
* the stopping sums are added over the blocks, in block order, on the
  first device.

``solve`` returns ``x`` after ``n_compare`` iterations joined on the first
device, and nothing else of the image's size there: before the join it
frees its blocks and the allocator's cached memory, so that the check's own
float64 images find the first card empty.  It imports nothing of the
program; ``inputs["y"]`` is the observation, whole or as row blocks on any
devices (each block is read onto its own device once, for ``A^H y``)."""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location("perfbench_reference_condat_vu",
                                               Path(__file__).with_name("condat_vu.py"))
cv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cv)

CHUNK_POINTS = 1 << 27  # image points of one chunk's transforms


def fast_len(n: int) -> int:
    """The least ``2^a 3^b >= n`` (the whole-image reference's grid)."""
    best = 1 << max(0, (n - 1).bit_length())
    p3 = 1
    while p3 < n:
        m = p3
        while m < n:
            m *= 2
        best = min(best, m)
        p3 *= 3
    return best


def smooth_len(n: int) -> int:
    """The least ``2^a 3^b 5^c 7^d >= n``: a size the FFT libraries
    transform fast."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def block_devices(device, n: int) -> list:
    """The devices of ``n`` row blocks: ``n`` cards from ``device`` on where
    there are as many, else ``device`` ``n`` times."""
    device = torch.device(device)
    if device.type == "cuda":
        first = device.index or 0
        if torch.cuda.device_count() >= first + n:
            return [torch.device("cuda", first + i) for i in range(n)]
    return [device] * n


def _norm_bound(h: torch.Tensor, grid) -> float:
    """``max |DFT_grid(h)|`` in float64, a block of columns at a time."""
    rows = torch.fft.rfft(h.to(torch.float64), n=grid[1], dim=1)
    step = max(1, CHUNK_POINTS // grid[0])
    return max(float(torch.max(torch.abs(torch.fft.fft(rows[:, c : c + step], n=grid[0], dim=0))))
               for c in range(0, rows.shape[1], step))


class Run:
    """``x`` after ``n_compare`` iterations (joined), ``x_end`` after the
    last (joined only when the solve stopped at the crossing, as the control
    reads it: beside the check's own float64 images a second whole one
    would not fit on the first card), ``crossed`` and ``n_run`` as
    ``condat_vu.Run``."""

    def __init__(self, x, x_end, crossed, n_run):
        self.x, self.x_end, self.crossed, self.n_run = x, x_end, crossed, n_run


class Blocked:
    """The problem on ``len(devices)`` row blocks of ``shape``."""

    def __init__(self, inputs, shape, devices, dtype):
        self.shape, self.devices, self.dtype = tuple(shape), list(devices), dtype
        self.ft = cv.fft_dtype(dtype)
        n = len(self.devices)
        H, W = self.shape
        if H % n:
            raise ValueError(f"{H} rows do not divide over {n} blocks")
        self.h_loc = H // n
        h = torch.as_tensor(inputs["psf"]).to(torch.float64)
        self.m = tuple(h.shape)
        m0, m1 = self.m
        self.o0, self.o1 = m0 // 2, m1 // 2
        if self.h_loc < m0:
            raise ValueError(f"blocks of {self.h_loc} rows are shorter than the {m0}-row PSF")
        grid = tuple(fast_len(s + k - 1) for s, k in zip(self.shape, self.m))
        self.beta = 2.0 * _norm_bound(h.to(self.devices[0]), grid) ** 2  # on the first card: ~1e9 points at 49152²
        self.psf = {d: h.to(d) for d in dict.fromkeys(self.devices)}
        self.chunk = max(1, min(self.h_loc, CHUNK_POINTS // W))
        self._hats = {}
        y = inputs["y"]
        ys = tuple(y[i * self.h_loc : (i + 1) * self.h_loc] for i in range(n)) if isinstance(y, torch.Tensor) else tuple(y)
        # A^H y: each block's y rows with o0 above and m0 - 1 - o0 below
        lo, hi = self.o0, m0 - 1 - self.o0
        self.atb = [self._adjoint_rows(self._extend(ys, i, lo, hi, self.ft), i, 0, self.h_loc).to(dtype)
                    for i in range(n)]

    # -- row blocks -----------------------------------------------------
    def _rows(self, blocks, i: int, start: int, stop: int, dtype):
        """Rows ``[start, stop)`` of block ``i``'s frame (0 its first row),
        from the neighbours where they lie outside it and zeros beyond the
        image, on block ``i``'s device."""
        h, dev, n = self.h_loc, self.devices[i], len(blocks)
        parts = []
        for j in range(i - 1 if start < 0 else i, (i + 1 if stop > h else i) + 1):
            a, b = max(start, (j - i) * h), min(stop, (j - i + 1) * h)
            if b <= a:
                continue
            if 0 <= j < n:
                parts.append(blocks[j][a - (j - i) * h : b - (j - i) * h].to(dev, dtype))
            else:
                parts.append(torch.zeros((b - a,) + tuple(blocks[i].shape[1:]), dtype=dtype, device=dev))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def _extend(self, blocks, i: int, lo: int, hi: int, dtype):
        return self._rows(blocks, i, -lo, self.h_loc + hi, dtype)

    def _hat(self, dev, rows: int):
        """The PSF's transfer on the grid of a chunk of ``rows`` rows."""
        m0, m1 = self.m
        grid = (smooth_len(rows + 3 * (m0 - 1)), smooth_len(self.shape[1] + m1 - 1))
        key = (dev, grid)
        if key not in self._hats:
            ctype = torch.complex128 if self.ft == torch.float64 else torch.complex64
            self._hats[key] = torch.fft.rfft2(self.psf[dev], s=grid).to(ctype)
        return grid, self._hats[key]

    def _adjoint_rows(self, r_ext, i: int, c0: int, c1: int):
        """``A^H r`` on block ``i``'s rows ``[c0, c1)``, from ``r_ext``: the
        rows ``[c0 - o0, c1 + m0 - 1 - o0)`` of ``r`` (zeros beyond the
        image), chunk by chunk: the valid correlation by ``h`` of ``r``
        padded by its zero columns."""
        (m0, m1), (o0, o1) = self.m, (self.o0, self.o1)
        out = []
        for a in range(c0, c1, self.chunk):
            b = min(c1, a + self.chunk)
            grid, hh = self._hat(self.devices[i], b - a)
            rp = torch.nn.functional.pad(r_ext[a - c0 : b - c0 + m0 - 1], (o1, m1 - 1 - o1))
            full = torch.fft.irfft2(torch.fft.rfft2(rp, s=grid) * torch.conj(hh), s=grid)
            out.append(full[: b - a, : self.shape[1]])
        return torch.cat(out) if len(out) > 1 else out[0]

    def grad(self, x, top, bot, i: int):
        """``2 (A^H (A x) - A^H y)`` on block ``i``, from its rows ``x`` and
        the ``m0 - 1`` rows above (``top``) and below (``bot``) it: per
        chunk, ``A x`` on the chunk's rows and the ``m0 - 1`` around them,
        cropped to the image, then ``A^H``, into one new block."""
        (m0, m1), (o0, o1), H = self.m, (self.o0, self.o1), self.shape[0]
        h, r0, dtype, W = self.h_loc, i * self.h_loc, self.dtype, self.shape[1]
        g = torch.empty_like(x)
        for a in range(0, h, self.chunk):
            b = min(h, a + self.chunk)
            grid, hh = self._hat(self.devices[i], b - a)
            xc = _frame(top, x, bot, a - (m0 - 1), b + m0 - 1).to(self.ft)
            full = torch.fft.irfft2(torch.fft.rfft2(xc, s=grid) * hh, s=grid)
            r = full[m0 - 1 : m0 - 1 + (b - a) + m0 - 1, o1 : o1 + W]  # A x, rows [a - o0, b + m0 - 1 - o0)
            rows = torch.arange(r0 + a - o0, r0 + b + m0 - 1 - o0, device=r.device)
            r = (r * ((rows >= 0) & (rows < H)).to(r.dtype)[:, None]).to(dtype).to(self.ft)
            adj = self._adjoint_rows(r, i, a, b).to(dtype)
            torch.sub(adj, self.atb[i][a:b], out=g[a:b]).mul_(2)
        return g


def _frame(top, core, bot, lo: int, hi: int):
    """Rows ``[lo, hi)`` of ``top``, ``core`` and ``bot`` stacked, counted
    from ``core``'s first row (a view where they lie in one of them)."""
    h, t = core.shape[0], top.shape[0]
    parts = [p for p, keep in ((top[max(lo, -t) + t : min(hi, 0) + t], lo < 0),
                               (core[max(lo, 0) : min(hi, h)], hi > 0 and lo < h),
                               (bot[max(lo, h) - h : hi - h], hi > h)) if keep]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _sumsq(a) -> torch.Tensor:
    a = a.to(torch.float64)
    return torch.sum(a * a)


def solve(inputs, cfg: dict, device, n_compare: int, n_run: int, tol: float, min_iter: int,
          dtype=torch.float64, stop_at_crossing: bool = False) -> Run:
    """``condat_vu.solve``'s iteration on ``cfg["mesh"]`` row blocks of the
    observation (on as many cards from ``device`` on as there are, else all
    on ``device``); ``x`` joined on ``device``."""
    y = inputs["y"]
    shape = tuple(y.shape) if isinstance(y, torch.Tensor) else (sum(b.shape[0] for b in y), y[0].shape[1])
    n = int(cfg["mesh"]["shape"][0])
    devices = block_devices(device, n)
    p = Blocked(inputs, shape, devices, dtype)
    lam, rho, nonneg = float(cfg["lam"]), float(cfg["rho"]), bool(cfg["nonneg"])
    tau, sigma = cv.steps(p.beta)
    m0, H, h = p.m[0], shape[0], p.h_loc
    x = [torch.zeros((h, shape[1]), dtype=dtype, device=d) for d in devices]
    z0 = [torch.zeros_like(b) for b in x]
    z1 = [torch.zeros_like(b) for b in x]
    dev0 = devices[0]
    x_at, crossed, k = None, None, 0
    for k in range(1, max(n_run, n_compare) + 1):
        tops = [p._rows(x, i, -(m0 - 1), 0, dtype) for i in range(n)]  # the m0 - 1 rows around each block
        bots = [p._rows(x, i, h, h + m0 - 1, dtype) for i in range(n)]
        z0_above = [p._rows(z0, i, -1, 0, dtype) for i in range(n)]  # the row above each block
        dx, u = [], []
        for i in range(n):
            last = (i + 1) * h == H  # the block holds the image's last row
            g = p.grad(x[i], tops[i], bots[i], i)  # grad F(x), then + K^T z in place
            # D^T z0 along the rows, (D^T z)_j = z_{j-1} - z_j with z_{-1} = z_{H-1} = 0,
            # in condat_vu's order: the subtractions, then the additions
            g[: h - 1].sub_(z0[i][: h - 1])
            if not last:
                g[h - 1].sub_(z0[i][h - 1])
            g[1:].add_(z0[i][: h - 1])
            g[0].add_(z0_above[i][0])
            cv._add_dt(g, z1[i], 1)
            t = torch.add(x[i], g, alpha=-tau, out=g)  # x' in g's memory
            if nonneg:
                t.clamp_min_(0)
            d = t - x[i]
            dx.append(d)
            u.append(torch.add(t, d, out=t))  # 2 x' - x, in the same memory
            del g, t, d
        del tops, bots
        u_below = [p._rows(u, i, h, h + 1, dtype) for i in range(n)]  # the row below each block
        d2, o2 = [], []
        for i in range(n):
            v0, v1 = z0[i].clone(), z1[i].clone()
            # D u along the rows, 0 on the image's last row
            v0[: h - 1].add_(u[i][1:] - u[i][: h - 1], alpha=sigma)
            if (i + 1) * h != H:
                v0[h - 1].add_(u_below[i][0] - u[i][h - 1], alpha=sigma)
            cv._add_d(v1, u[i], 1, sigma)
            # the projection onto the lam-ball of each pixel's (v0, v1): condat_vu's
            # clamp(lam / sqrt(v0^2 + v1^2), max=1) (lam / t is t.reciprocal() * lam) in one buffer
            scale = v0 * v0
            scale += v1 * v1
            scale.sqrt_().reciprocal_().mul_(lam).clamp_(max=1.0)
            z0[i] = z0[i].mul_(1 - rho).add_(v0.mul_(scale), alpha=rho)
            z1[i] = z1[i].mul_(1 - rho).add_(v1.mul_(scale), alpha=rho)
            del v0, v1, scale
            d2.append(_sumsq(dx[i]).to(dev0))
            o2.append(_sumsq(x[i]).to(dev0))
            x[i].add_(dx[i], alpha=rho)  # rho x' + (1 - rho) x
        del u, u_below, dx
        s_d2, s_o2 = (float(v) for v in torch.stack([sum(d2[1:], d2[0]), sum(o2[1:], o2[0])]).tolist())
        d2v, o2v = rho * rho * s_d2, s_o2
        rel = math.sqrt(d2v) / math.sqrt(o2v) if o2v > 0 else (0.0 if d2v == 0 else math.inf)
        if crossed is None and k >= min_iter and rel <= tol:
            crossed = k
        if k == n_compare:
            x_at = [b.clone() for b in x]
        if stop_at_crossing and crossed is not None and k >= n_compare:
            break
    del z0, z1, p
    _release(devices)
    at = x_at if x_at is not None else x
    joined = join(at, dev0)
    x_end = join(x, dev0) if stop_at_crossing else None
    del at, x_at, x
    _release(devices)
    return Run(joined, x_end, crossed, k)


def _release(devices) -> None:
    """Give the allocator's cached blocks on the blocks' cards back."""
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def join(blocks, device) -> torch.Tensor:
    """The row blocks in one tensor on ``device``, each copied into its rows."""
    h = blocks[0].shape[0]
    out = torch.empty((h * len(blocks),) + tuple(blocks[0].shape[1:]), dtype=blocks[0].dtype, device=device)
    for i, b in enumerate(blocks):
        out[i * h : (i + 1) * h].copy_(b)
    return out
