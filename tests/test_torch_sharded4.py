"""The row-sharded TV deconvolution of the four-card cell
(``tvdeconv-gauss15-rows4``) on a four-position CPU mesh.

* A sharded build at 1024² (the routed ``PDS`` and
  ``DistributedTVDeconv2D``'s megasp engine) takes no numpy transform
  larger than the PSF's 1-D grids (numpy's FFT patched to record); megasp
  builds the chain's FFT transfers only on their first use, with the values
  a build at construction gave.
* The routed ``PDS`` (the chain on CPU devices) and
  ``DistributedTVDeconv2D(use_pallas="interpret")`` (K14's plain twin)
  against the benchmark's blocked float64 reference after 40 iterations:
  ``x`` within 2e-5 relative in l2 and 2e-4 of ``max |x|`` at any pixel
  (float32 against float64: 40 iterations of rounding near 1e-7 each, and
  a Gram summed in another order).
* The blocked reference against the whole-image reference
  (``perfbench/reference/tvdeconv-gauss15.py``) in float64 within 1e-12,
  with blocks cut into chunks of rows and whole.
* The spans ``sp.halo`` and ``sp.fold`` once a step, ``sp.gather`` once a
  joined entry, ``pds.route`` once a routing, and the counter
  ``sp.halo_bytes`` of an exchange between two devices.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from pycsou_tpu_torch.core.solver import Deferred, Iterand
from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu_torch.ops import Convolve2D, Gradient
from pycsou_tpu_torch.opt import PDS
from pycsou_tpu_torch.parallel import DistributedTVDeconv2D, NamedSharding, PartitionSpec, make_mesh
from pycsou_tpu_torch.parallel.spatial import _fetch, conv_transfer
from pycsou_tpu_torch.utils import profiling
from pycsou_tpu_torch.utils.device import set_default_device

ROOT = Path(__file__).resolve().parents[1]
LAM = 0.05
CFG = {"lam": LAM, "rho": 0.9, "nonneg": True, "mesh": {"shape": [4], "axis": "sp"},
       "psf": {"taps": 15, "sigma": 2.0}, "noise_std": 0.01}


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _load(rel: str):
    import sys

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.harness.spec import load_module

    return load_module(ROOT / rel, rel.split("/")[1])


@pytest.fixture(scope="module")
def ref():
    return _load("perfbench/reference/tvdeconv-gauss15-rows4.py")


@pytest.fixture(scope="module")
def cfgmod():
    return _load("perfbench/configs/tvdeconv-gauss15-rows4.py")


def _gauss():
    ax = np.arange(15) - 7
    g = np.exp(-(ax**2) / 8.0)
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def _mesh():
    return make_mesh((4,), ("sp",), devices=["cpu"] * 4)


def _pds(y, shape, **kw):
    return PDS(shape, F=SquaredL2Loss(shape, data=y) * Convolve2D(shape, _gauss(), device="cpu"),
               G=NonNegativeOrthant(shape), H=LAM * L21Norm((2,) + shape, axis=0), K=Gradient(shape), **kw)


def _observation(cfgmod, shape, seed=2**35 + 26):
    return cfgmod.observation(CFG, shape, seed, 0, cfgmod.shared_inputs(CFG, shape, seed, "cpu"), "cpu")


def test_sharded_build_takes_no_image_sized_host_transform(cfgmod, monkeypatch):
    shape = (1024, 1024)
    y = _observation(cfgmod, shape)
    sizes = []
    for fn in ("fft", "rfft", "fftn", "rfftn", "fft2", "rfft2"):
        real = getattr(np.fft, fn)

        def rec(*a, _real=real, **k):
            out = _real(*a, **k)
            sizes.append(out.size)
            return out

        monkeypatch.setattr(np.fft, fn, rec)
    routed = _pds(y, shape, max_iter=10).with_shardings(x=NamedSharding(_mesh(), PartitionSpec("sp", None)))
    fused = DistributedTVDeconv2D(shape, _gauss(), y, LAM, mesh=_mesh(), use_pallas="interpret")
    assert isinstance(routed._fused, DistributedTVDeconv2D) and fused.stencil_mode == "megasp"
    one_d = max(n + 15 - 1 for n in shape) // 2 + 1  # the largest 1-D rfft the PSF's grids could take
    assert max(sizes, default=0) <= one_d, sizes
    # megasp reads no FFT transfer: they wait for a first use (the chain's A^H y is one), and then
    # hold what a build at construction held
    assert fused._hats is None and routed._fused._hats is not None
    h = 1024 // 4
    want = conv_transfer(fused.filt, (h + 14, 1024))
    assert torch.equal(fused._h_hat_fwd[torch.device("cpu")], want)
    assert fused._hats is not None


def _solve_fixed(solver, n):
    return solver.postprocess(solver.run_fixed(n))["x"]


@pytest.mark.parametrize("engine", ["routed_chain", "interpret_megasp"])
def test_sharded_solvers_match_the_blocked_reference(cfgmod, ref, engine):
    shape = (128, 96)
    y = _observation(cfgmod, shape)
    pds = _pds(y, shape, max_iter=40)
    if engine == "routed_chain":
        solver = pds.with_shardings(x=NamedSharding(_mesh(), PartitionSpec("sp", None)))
        assert isinstance(solver._fused, DistributedTVDeconv2D) and solver._fused.stencil_mode == ""
    else:
        solver = DistributedTVDeconv2D(shape, _gauss(), y, LAM, mesh=_mesh(), use_pallas="interpret",
                                       tau=pds._fused.tau, rho=0.9)
        assert solver.stencil_mode == "megasp"
    x = _solve_fixed(solver, 40).double()
    inputs = cfgmod.reference_inputs(CFG, shape, 2**35 + 26, 0, "cpu")
    run = ref.solve(inputs, CFG, "cpu", n_compare=40, n_run=40, tol=1e-6, min_iter=50)
    assert run.n_run == 40 and run.x.dtype == torch.float64
    l2 = float(torch.linalg.vector_norm(x - run.x) / torch.linalg.vector_norm(run.x))
    mx = float(torch.max(torch.abs(x - run.x)) / torch.max(torch.abs(run.x)))
    assert l2 <= 2e-5 and mx <= 2e-4, (l2, mx)


@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_blocked_reference_matches_the_whole_image_reference(cfgmod, ref, chunk_rows, monkeypatch):
    whole = _load("perfbench/reference/tvdeconv-gauss15.py")
    shape = (96, 80)
    if chunk_rows:
        monkeypatch.setattr(ref, "CHUNK_POINTS", chunk_rows * shape[1])
    y = _observation(cfgmod, shape)
    psf = cfgmod.psf(CFG)
    kw = dict(n_compare=40, n_run=70, tol=2e-3, min_iter=10, dtype=torch.float64)
    a = whole.solve({"y": y, "psf": psf}, CFG, "cpu", **kw)
    b = ref.solve({"y": y, "psf": psf}, CFG, "cpu", **kw)
    assert a.crossed is not None and a.crossed == b.crossed and a.n_run == b.n_run == 70
    assert float(torch.max(torch.abs(a.x - b.x)) / torch.max(torch.abs(a.x))) <= 1e-12
    assert b.x_end is None  # joined only for the control
    c = ref.solve({"y": y, "psf": psf}, CFG, "cpu", **dict(kw, stop_at_crossing=True))
    d = whole.solve({"y": y, "psf": psf}, CFG, "cpu", **dict(kw, stop_at_crossing=True))
    assert c.n_run == d.n_run and float(torch.max(torch.abs(c.x_end - d.x_end))) <= 1e-12 * float(d.x_end.abs().max())


def test_spans_and_counter_once_a_step(cfgmod):
    from torch.profiler import ProfilerActivity, profile

    shape = (128, 96)
    y = _observation(cfgmod, shape)
    solver = DistributedTVDeconv2D(shape, _gauss(), y, LAM, mesh=_mesh(), use_pallas="interpret")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        st = solver.run_fixed(3)
        solver.postprocess(st)
        _pds(y, shape).with_shardings(x=NamedSharding(_mesh(), PartitionSpec("sp", None)))
        # an exchange between two devices: a block on the CPU sends its rows to one on "meta"
        src, dst = torch.ones(8, 5), torch.empty(8, 5, device="meta")
        got = _fetch([(src, lambda s: s[-2:], dst)])
    names = [r.name for r in profiling.records()]
    counters = profiling.counters()
    profiling.reset()
    assert names.count("sp.halo") == 3 and names.count("sp.fold") == 3
    assert names.count("sp.gather") == 3  # x, z0 and z1 joined
    assert names.count("pds.route") == 1
    assert got[0].device.type == "meta" and counters.get("sp.halo_bytes") == 2 * 5 * 4
    # one device: the exchange moves no bytes between devices
    with profile(activities=[ProfilerActivity.CPU]):
        solver.run_fixed(2)
    assert "sp.halo_bytes" not in profiling.counters()
    profiling.reset()


def test_routed_solve_joins_x_and_the_duals(cfgmod):
    """``solve()`` of the routed ``PDS``: ``x`` joined on the first device,
    and the stacked duals there on the first read of ``z``, equal to the
    shards' rows."""
    shape = (128, 96)
    y = _observation(cfgmod, shape)
    routed = _pds(y, shape, max_iter=32, min_iter=32, accuracy_threshold=0.0).with_shardings(
        x=NamedSharding(_mesh(), PartitionSpec("sp", None)))
    info = routed.solve()
    st = routed.run_fixed(32)
    # x is joined at once; the duals on the first read of z (they wait as shards until then)
    assert isinstance(info.iterand, Iterand) and isinstance(dict.__getitem__(info.iterand, "z"), Deferred)
    assert info.n_iter == 32 and torch.equal(info["x"], torch.cat(st["x"]))
    copied = dict(info.iterand)  # a copy reads through the joins
    assert {"x", "z"} <= set(copied) and all(not isinstance(v, Deferred) for v in copied.values())
    assert tuple(info["z"].shape) == (2,) + shape
    assert torch.equal(info["z"], torch.cat(st["z"], dim=-2))
    assert torch.equal(dict.__getitem__(info.iterand, "z"), info["z"])  # joined once, then kept
