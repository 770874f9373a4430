"""``ops.conv.fft_norm_bound``, the convolutions' norm bound ``max
|DFT_grid(h)|``, against numpy's transform of the whole grid, on the CPU.

Each route is held within 1e-12 relative of ``np.fft.rfftn`` (``fftn``
for a complex filter) on grids of fast and of other lengths: the DC term of
a filter with no negative tap, the product of the 1-D maxima of an exactly
rank-1 one, the blocked transform of any other on the host (numpy's own
order, so equal value for value) and on a device (``torch.fft``, the card's
route, run here on the CPU).  1e-12 leaves room for the float64 rounding of
a different order of operations (about 1e-15) and none for a wrong grid.
The convolution classes, the sharded solvers' ``_fft_beta`` and the
routes' host transforms (numpy's FFT patched to record) are checked
alongside."""
import numpy as np
import pytest
import torch

from pycsou_tpu_torch.ops import conv as tconv
from pycsou_tpu_torch.ops.conv import Convolve1D, Convolve2D, ConvolveND, fft_norm_bound, next_fast_len
from pycsou_tpu_torch.parallel.solvers import _fft_beta
from pycsou_tpu_torch.utils.device import set_default_device

REL = 1e-12


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _gauss(k=15, s=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def _psfs():
    rng = np.random.default_rng(26)
    u, v = rng.standard_normal((9, 2)), rng.standard_normal((7, 2))
    return {
        "gauss15": _gauss(),
        "rank2": (u @ v.T).astype(np.float32),
        "full_signed": rng.standard_normal((11, 11)).astype(np.float32),
        "even": rng.standard_normal((4, 6)).astype(np.float32),
        "rank1_signed": np.outer([1.0, -2.0, 1.0], [1.0, 2.0, 1.0]).astype(np.float32),
        "1d": rng.standard_normal(9).astype(np.float32),
        "3d": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "complex": rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3)),
    }


PSFS = _psfs()


def _numpy_max(h, grid):
    axes = tuple(range(len(grid)))
    if np.iscomplexobj(h):
        return float(np.max(np.abs(np.fft.fftn(h.astype(np.complex128), s=grid, axes=axes))))
    return float(np.max(np.abs(np.fft.rfftn(h.astype(np.float64), s=grid, axes=axes))))


def _grids(h):
    """A fast grid and one of plain ``n + m - 1`` lengths (primes among them)."""
    ns = (1021, 600) if h.ndim == 2 else (200,) if h.ndim == 1 else (31, 20, 17)
    plain = tuple(n + m - 1 for n, m in zip(ns, h.shape))
    return [tuple(next_fast_len(p) for p in plain), plain]


@pytest.mark.parametrize("name", sorted(PSFS))
def test_bound_equals_the_full_transform(name):
    h = PSFS[name]
    for grid in _grids(h):
        want = _numpy_max(h, grid)
        assert fft_norm_bound(h, grid) == pytest.approx(want, rel=REL), grid
        # the card's route, the transform in float64 blocks through torch.fft
        assert tconv._full_bound_torch(h, grid, torch.device("cpu")) == pytest.approx(want, rel=REL), grid


@pytest.mark.parametrize("name", ["full_signed", "even", "1d", "3d", "complex"])
def test_the_host_route_is_numpys_transform(name, monkeypatch):
    """With blocks of a few columns, the blocked host transform still gives
    numpy's value exactly: the first axis's 1-D transforms do not depend on
    their neighbours."""
    monkeypatch.setattr(tconv, "_BOUND_BLOCK", 64)
    h = PSFS[name]
    for grid in _grids(h):
        assert tconv._full_bound(h, grid, None) == _numpy_max(h, grid)


def _recording(monkeypatch):
    """Patch numpy's transforms to record the size of each output."""
    sizes = []
    for fn in ("fft", "rfft", "fftn", "rfftn", "fft2", "rfft2"):
        real = getattr(np.fft, fn)

        def rec(*a, _real=real, **k):
            out = _real(*a, **k)
            sizes.append(out.size)
            return out

        monkeypatch.setattr(np.fft, fn, rec)
    return sizes


@pytest.mark.parametrize("name,largest", [("gauss15", 0), ("rank1_signed", 1024 // 2 + 1)])
def test_separable_routes_take_no_grid_sized_transform(name, largest, monkeypatch):
    """A filter with no negative tap takes no transform; an exactly rank-1
    one takes its two 1-D ones (``rfft`` of the grid's lengths)."""
    h = PSFS[name]
    sizes = _recording(monkeypatch)
    want_grid = (1024, 1024)
    fft_norm_bound(h, want_grid)
    assert max(sizes, default=0) <= largest


def test_rank1_route_needs_an_exact_rank1_filter():
    """The float32 Gaussian is rank 1 only to ~1e-8: a signed copy of it is
    not taken as rank 1 (the product of the 1-D maxima would be 1e-8 off),
    and the bound still equals the full transform's."""
    h = _gauss()
    h[0, 0] = -h[0, 0]
    assert tconv._rank1_bound(h.astype(np.float64), (64, 64)) is None
    assert fft_norm_bound(h, (64, 64)) == pytest.approx(_numpy_max(h, (64, 64)), rel=REL)


@pytest.mark.parametrize("name", ["gauss15", "rank2", "full_signed", "even"])
def test_convolutions_and_the_sharded_beta_keep_their_values(name):
    """``Convolve2D.lipschitz`` (``next_fast_len`` grids) and the sharded
    solvers' ``_fft_beta`` (``(H + m0 - 1, W + m1 - 1)``, the reference's
    complex ``fftn``) against numpy's full transforms."""
    h = PSFS[name]
    shape = (97, 130)
    A = Convolve2D(shape, h, device="cpu")
    grid = tuple(next_fast_len(n + m - 1) for n, m in zip(shape, h.shape))
    assert A.lipschitz == pytest.approx(_numpy_max(h, grid), rel=REL)
    plain = tuple(n + m - 1 for n, m in zip(shape, h.shape))
    want = 2.0 * float(np.max(np.abs(np.fft.fftn(h.astype(np.float64), s=plain, axes=(0, 1))))) ** 2
    assert _fft_beta(h, *shape) == pytest.approx(want, rel=REL)
    given = Convolve2D(shape, h, device="cpu", lipschitz=3.0)
    assert given.lipschitz == 3.0 and given.gram.lipschitz == 9.0


def test_convolutions_1d_and_nd():
    h1, h3 = PSFS["1d"], PSFS["3d"]
    A = Convolve1D((200,), h1, device="cpu")
    assert A.lipschitz == pytest.approx(_numpy_max(h1, (next_fast_len(208),)), rel=REL)
    B = ConvolveND((31, 20, 17), h3, device="cpu")
    grid = tuple(next_fast_len(n + m - 1) for n, m in zip((31, 20, 17), h3.shape))
    assert B.lipschitz == pytest.approx(_numpy_max(h3, grid), rel=REL)


def test_bound_checks_its_grid():
    with pytest.raises(ValueError, match="grid"):
        fft_norm_bound(PSFS["gauss15"], (64,))
