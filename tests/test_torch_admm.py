"""ConsensusADMM and stack_operators of the port (opt/admm.py) on the CPU,
against the JAX package on its 8-device CPU mesh, with the same numpy
inputs.

The port runs on meshes of 1, 2 and 8 CPU devices (``make_mesh(...,
devices=["cpu"] * n)``); its z-update adds the per-block sums of ``x + u``
in mesh order, the reference's ``psum`` in its own.  Tolerances, on
max(1, max |z|) for the absolute part: the Fourier backend (FFTs in
another library) rtol 3e-4 / atol 3e-5; the CG backend (products summed in
another order, each CG stopping on its own test) rtol 3e-4 / atol 3e-5;
a JAX state carried across and run on: the same.  The metric history (a
ratio of iterate differences that shrink to 1e-5 of the iterates, so
float32 noise shows at 1e-2 of it): rtol 1e-2 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.ops as jops
from pycsou_tpu.ops.conv import CircularConvolve as JCircularConvolve
from pycsou_tpu.opt.admm import ConsensusADMM as JConsensusADMM
from pycsou_tpu.opt.admm import stack_operators as j_stack_operators
from pycsou_tpu.parallel import make_mesh as j_make_mesh
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
from pycsou_tpu_torch.opt import ConsensusADMM
from pycsou_tpu_torch.opt.admm import stack_operators
from pycsou_tpu_torch.parallel import make_mesh
from pycsou_tpu_torch.utils.convert import consensus_state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device

TOL = dict(rtol=3e-4, atol=3e-5)
S = 8


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


def _cpu_mesh(n):
    return make_mesh((n,), ("dp",), devices=["cpu"] * n)


def _fourier_problem(seed, shape, psf):
    """S circular-convolution scenarios of one x (tests/test_admm.py's
    settings): their JAX transfer functions and noisy data."""
    rng = np.random.default_rng(seed)
    x_true = rng.standard_normal(shape).astype(np.float32)
    h_hats, ys = [], []
    for _ in range(S):
        op = JCircularConvolve(shape, psf(rng))
        h_hats.append(np.asarray(op.h_hat))
        ys.append(np.asarray(op(jnp.asarray(x_true))) + 0.01 * rng.standard_normal(shape).astype(np.float32))
    return np.stack(h_hats), np.stack(ys)


def _psf_5x5(rng):  # tests/test_admm.py:43
    return rng.standard_normal((5, 5)).astype(np.float32) / 5 + np.eye(5, dtype=np.float32)[2, :] * 0.5


def _psf_3x3(rng):  # tests/test_admm.py:70
    h = np.zeros((3, 3), np.float32)
    h[1, 1] = 1.0
    return h + 0.2 * rng.standard_normal((3, 3)).astype(np.float32)


_FOURIER = {}


def _jax_fourier(case):
    """The JAX solver on its 8-device mesh and its state after 30 iterations
    (one JAX run a case, cached in the module)."""
    if case not in _FOURIER:
        shape, psf, rho = {"5x5": ((16, 16), _psf_5x5, 1.0), "3x3": ((8, 8), _psf_3x3, 2.0)}[case]
        h_hats, ys = _fourier_problem(7, shape, psf)
        jadmm = JConsensusADMM(shape, h_hats, ys, g=jfunc.NonNegativeOrthant(shape), rho=rho,
                               mesh=j_make_mesh((8,), ("dp",)))
        jst = {k: np.asarray(v) for k, v in jadmm.run_fixed(30).items()}
        _FOURIER[case] = (shape, rho, h_hats, ys, jadmm, jst)
    return _FOURIER[case]


@pytest.mark.parametrize("case", ["5x5", "3x3"])
@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_fourier_backend_matches_jax(case, n_dev):
    """The Fourier x-update with ``NonNegativeOrthant`` on z: z and u after
    30 iterations on port meshes of 1, 2 and 8 CPU devices."""
    shape, rho, h_hats, ys, _, jst = _jax_fourier(case)
    admm = ConsensusADMM(shape, h_hats, ys, g=tfunc.NonNegativeOrthant(shape), rho=rho, mesh=_cpu_mesh(n_dev))
    st = admm.run_fixed(30)
    assert len(st["u"]) == n_dev and all(u.shape[0] == S // n_dev for u in st["u"])
    out = state_to_numpy(st)
    _close(out["z"], jst["z"])
    _close(out["u"], jst["u"])
    np.testing.assert_allclose(out["history"][1:30], jst["history"][1:30], rtol=1e-2, atol=1e-6)


def test_state_converts_across():
    """A JAX state after 30 iterations, carried into the port on a 2-device
    mesh (``consensus_state_from_numpy``), runs on to the JAX solver's state
    after 40."""
    shape, rho, h_hats, ys, jadmm, jst = _jax_fourier("3x3")
    mesh = _cpu_mesh(2)
    admm = ConsensusADMM(shape, h_hats, ys, g=tfunc.NonNegativeOrthant(shape), rho=rho, mesh=mesh)
    st = consensus_state_from_numpy(jst, mesh)
    assert st["it"] == 30 and [u.shape[0] for u in st["u"]] == [4, 4]
    out = state_to_numpy(admm.run_fixed(10, state=st))
    jst40 = jadmm.run_fixed(10, state=jadmm._wrap_state({k: jnp.asarray(v) for k, v in jst.items()}))
    assert int(out["it"]) == int(jst40["it"]) == 40
    _close(out["z"], jst40["z"])
    _close(out["u"], jst40["u"])


def _dense_problem(seed, n, m, noise):
    rng = np.random.default_rng(seed)
    x_true = rng.standard_normal(n).astype(np.float32)
    mats = [rng.standard_normal((m, n)).astype(np.float32) for _ in range(S)]
    ys = np.stack([M @ x_true + noise * rng.standard_normal(m).astype(np.float32) for M in mats])
    return x_true, mats, ys


@pytest.mark.parametrize("n_dev", [1, 8])
def test_cg_backend_matches_jax(n_dev):
    """The CG x-update on ``DenseOperator``s (tests/test_admm.py:101): z and
    u after 12 iterations, one batched CG a block."""
    _, mats, ys = _dense_problem(11, 12, 20, 0.01)
    jadmm = JConsensusADMM((12,), ops=j_stack_operators([jops.DenseOperator(jnp.asarray(M)) for M in mats]),
                           data=ys, rho=1.0, mesh=j_make_mesh((8,), ("dp",)), cg_maxiter=40)
    jst = jadmm.run_fixed(12)
    admm = ConsensusADMM((12,), ops=stack_operators([tops.DenseOperator(M) for M in mats]), data=ys, rho=1.0,
                         mesh=_cpu_mesh(n_dev), cg_maxiter=40)
    out = state_to_numpy(admm.run_fixed(12))
    _close(out["z"], jst["z"])
    _close(out["u"], jst["u"])


def test_solve_converges_with_history():
    """``solve()`` (tests/test_admm.py:128): converged within tol with its
    metric history and per-variable diagnostics, z at the JAX solver's,
    the first converged iteration within one of the reference's stop."""
    x_true, mats, ys = _dense_problem(12, 10, 16, 0.0)
    kw = dict(data=ys, rho=1.0, max_iter=2000, accuracy_threshold=1e-6)
    jinfo = JConsensusADMM((10,), ops=j_stack_operators([jops.DenseOperator(jnp.asarray(M)) for M in mats]),
                           mesh=j_make_mesh((8,), ("dp",)), **kw).solve()
    info = ConsensusADMM((10,), ops=stack_operators([tops.DenseOperator(M) for M in mats]), mesh=_cpu_mesh(8),
                         **kw).solve()
    assert info.converged and jinfo.converged
    assert info.history[info.converged_at - 1] <= 1e-6
    assert abs(info.converged_at - jinfo.n_iter) <= 1
    assert set(info.diagnostics) == {"u", "z"}
    assert torch.equal(info["x"], info["z"]) and info["u"].shape == (S, 10)
    _close(info["z"], jinfo["z"])
    np.testing.assert_allclose(info["z"].numpy(), x_true, rtol=1e-2, atol=1e-2)


def test_stack_operators_rejects_a_mix():
    """A mix of classes, shapes or methods raises, as the reference's tree
    check; band ``Convolve2D``s of other Gaussians (other values, another
    ``lipschitz``) stack."""
    with pytest.raises(ValueError):
        stack_operators([tops.DenseOperator(np.ones((3, 3))), tops.DiagonalOperator(np.ones(3))])
    with pytest.raises(ValueError):
        stack_operators([tops.DenseOperator(np.ones((3, 3))), tops.DenseOperator(np.ones((4, 3)))])
    h = np.outer(np.hanning(5), np.hanning(5)).astype(np.float32) + 0.01
    with pytest.raises(ValueError):
        stack_operators([tops.Convolve2D((16, 16), h), tops.Convolve2D((16, 16), h, method="fft")])
    with pytest.raises(ValueError):
        stack_operators([])
    g = [np.exp(-((np.arange(7) - 3.0) ** 2) / (2 * s**2)) for s in (1.0, 2.0)]
    st = stack_operators([tops.Convolve2D((16, 16), np.outer(u, u) / np.outer(u, u).sum()) for u in g])
    assert len(st) == 2 and st[1].dim_shape == (16, 16)


def test_mesh_rules():
    """``mesh=None`` without CUDA raises naming ``devices=``; S must divide
    over the mesh, with the reference's message."""
    h_hats, ys = _fourier_problem(3, (8, 8), _psf_3x3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            ConsensusADMM((8, 8), h_hats, ys)
    with pytest.raises(ValueError, match="number of scenarios 8 must divide over 3 devices"):
        ConsensusADMM((8, 8), h_hats, ys, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="exactly one"):
        ConsensusADMM((8, 8), data=ys, mesh=_cpu_mesh(1))
