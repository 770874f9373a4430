"""The reference's solver switches on the CPU.

* ``TVDeconvolution(use_pallas=False)`` and ``stencil="xla"`` take the
  plain engine, whose iterates are the reference's ``use_pallas=False``
  (XLA stencil) iterates in conv, mask and combined modes, anisotropic too:
  rtol 1e-4 / atol 1e-5 max|x| after 7 iterations.  ``"xla"`` wins over
  ``use_pallas``; ``use_pallas=True`` on the CPU and a CUDA engine named
  with ``use_pallas=False`` raise (``tests/test_torch_gpu.py`` pins
  ``use_pallas=False`` raising on a card).
* ``ConsensusADMM(dtype=)`` takes float32 in its three spellings, with the
  iterates of the default, and raises ``ValueError`` for any other dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.opt as jopt
from pycsou_tpu.ops.conv import CircularConvolve as JCircular
from pycsou_tpu.opt.admm import ConsensusADMM as JADMM
from pycsou_tpu.parallel import make_mesh as j_make_mesh
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.opt.admm import ConsensusADMM
from pycsou_tpu_torch.parallel import make_mesh
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


S = (24, 40)
N = 7


def _psf(k=5):
    g = np.hanning(k + 2)[1:-1]
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _problem(mode, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(S).astype(np.float32)
    kw = {}
    if mode in ("conv", "combined"):
        kw["filt"] = _psf()
    if mode in ("mask", "combined"):
        kw["mask"] = (rng.random(S) < 0.6).astype(np.float32)
        y = kw["mask"] * y
    return y, kw


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("switch", [dict(use_pallas=False), dict(stencil="xla"),
                                    dict(stencil="xla", use_pallas=True)], ids=["use_pallas", "xla", "xla-wins"])
@pytest.mark.parametrize("mode", ["conv", "mask", "combined", "denoise-aniso"])
def test_plain_switches_match_reference_xla(mode, switch):
    y, kw = _problem("conv" if mode == "denoise-aniso" else mode)
    if mode == "denoise-aniso":
        kw = dict(isotropic=False)
    t = topt.TVDeconvolution(S, y, 0.05, **kw, **switch)
    assert t.stencil_mode == "plain" and t.use_pallas is False
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    j = jopt.TVDeconvolution(S, jnp.asarray(y), 0.05, use_pallas=False, **jkw)
    assert j.stencil_mode == "xla"
    ts, js = t.run_fixed(N), j.run_fixed(N)
    for k in ("x", "z0", "z1"):
        _close(ts[k], js[k])


def test_auto_and_true_keep_the_pick():
    y, kw = _problem("conv")
    assert topt.TVDeconvolution(S, y, 0.05, **kw).stencil_mode == "plain"
    with pytest.raises(ValueError, match="use_pallas=True launches CUDA kernels"):
        topt.TVDeconvolution(S, y, 0.05, use_pallas=True, **kw)
    with pytest.raises(ValueError, match="launches CUDA kernels"):  # as a CUDA engine named on the CPU
        topt.TVDeconvolution(S, y, 0.05, stencil="megar", **kw)


@pytest.mark.parametrize("engine", ["megar", "mega3", "sweep"])
def test_cuda_engine_with_use_pallas_false_raises(engine):
    y, kw = _problem("conv")
    with pytest.raises(ValueError, match="use_pallas=False"):
        topt.TVDeconvolution(S, y, 0.05, stencil=engine, use_pallas=False, **kw)


def test_bad_use_pallas_raises():
    y, kw = _problem("conv")
    with pytest.raises(ValueError, match="use_pallas"):
        topt.TVDeconvolution(S, y, 0.05, use_pallas="interpret", **kw)


def _admm_problem(seed=1, S_=4, shape=(8, 8)):
    rng = np.random.default_rng(seed)
    h = np.zeros(shape, np.float32)
    h[:2, :2] = rng.random((2, 2))
    h_hat = np.asarray(JCircular(shape, jnp.asarray(h)).h_hat)
    h_hats = np.stack([h_hat] * S_)
    data = rng.standard_normal((S_,) + shape).astype(np.float32)
    return shape, h_hats, data


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, "float32"], ids=["torch", "numpy", "str"])
def test_admm_takes_float32(dtype):
    shape, h_hats, data = _admm_problem()
    mesh = make_mesh((2,), ("dp",), devices=["cpu"] * 2)
    t = ConsensusADMM(shape, h_hats, data, rho=1.0, mesh=mesh, dtype=dtype)
    base = ConsensusADMM(shape, h_hats, data, rho=1.0, mesh=mesh)
    assert torch.equal(t.run(5), base.run(5))
    j = JADMM(shape, jnp.asarray(h_hats), jnp.asarray(data), rho=1.0, mesh=j_make_mesh((2,), ("dp",)),
              dtype=jnp.float32)
    _close(t.run(5), j.run(5))


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, "float64", torch.complex64, np.complex64, "bfloat16"])
def test_admm_other_dtypes_raise(dtype):
    shape, h_hats, data = _admm_problem()
    with pytest.raises(ValueError, match="float32"):
        ConsensusADMM(shape, h_hats, data, mesh=make_mesh((2,), ("dp",), devices=["cpu"] * 2), dtype=dtype)
