"""``with_shardings`` of the port against the JAX package, on the CPU.

The twins of ``tests/test_generic_sharded.py``, of ``tests/test_fuse.py``'s
drop to the generic chain and of ``tests/test_langevin.py``'s PMYULA twin:
the port's meshes hold ``devices=["cpu"] * n``, the JAX side's the
conftest's virtual devices.  The port has no SPMD partitioner, so its
generic chain keeps the state whole: its sharded iterates equal its
unsharded ones bit for bit, and the JAX solve's (sharded or not, which the
reference's tests hold equal) within rtol 1e-4 / atol 1e-5 max|x|.  A fused
TV expression with a row (``("sp", None)``) or 2-D (``("sp0", "sp1")``)
sharding routes onto ``DistributedTVDeconv2D`` or ``Spatial2DTVDeconv2D``
(their chains on CPU devices), held to the JAX package's routed solve.
The port's own cases: ``NamedSharding`` round trips, an axis that does not
divide, a routed state saved and resumed, a constructor error that is not a
gate propagating, and a mesh on another device than the solver's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as JP

import pycsou_tpu.func as jfunc
import pycsou_tpu.opt as jopt
from pycsou_tpu.func.penalty import L1Norm as JL1Norm
from pycsou_tpu.func.penalty import L21Norm as JL21Norm
from pycsou_tpu.ops.conv import Convolve2D as JConvolve2D
from pycsou_tpu.ops.diff import Gradient as JGradient
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch import parallel
from pycsou_tpu_torch.parallel import NamedSharding, PartitionSpec, make_mesh
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The CPU, on one thread: the shards are small, and OpenMP's barriers
    over many threads cost more than the work when the cores are shared."""
    threads = torch.get_num_threads()
    set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_default_device(None)


def _gauss(k, s):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def _close(got, want, rtol=1e-4):
    """rtol 1e-4, atol 1e-5 max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _mesh(n, names=("sp",), shape=None):
    return make_mesh(shape or (n,), names, devices=["cpu"] * n)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _rows(mesh):
    return NamedSharding(mesh, PartitionSpec("sp", None))


def _tv_pds(lib, shape, y, filt, fuse, **kw):
    """The README's TV deconvolution ``PDS`` in the port (``lib`` "t") or
    the JAX package ("j")."""
    if lib == "t":
        A = tops.Convolve2D(shape, filt)
        return topt.PDS(shape, F=tfunc.SquaredL2Loss(shape, data=y) * A, G=tfunc.NonNegativeOrthant(shape),
                        H=0.05 * tfunc.L21Norm((2,) + shape, axis=0), K=tops.Gradient(shape), fuse=fuse, **kw)
    A = JConvolve2D(shape, jnp.asarray(filt))
    return jopt.PDS(shape, F=jfunc.SquaredL2Loss(shape, data=jnp.asarray(y)) * A,
                    G=jfunc.NonNegativeOrthant(shape), H=0.05 * JL21Norm((2,) + shape, axis=0),
                    K=JGradient(shape), fuse=fuse, **kw)


def _deconv_data(rng, shape, filt):
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    return np.asarray(JConvolve2D(shape, jnp.asarray(filt))(jnp.asarray(x_true)))


def _z(state):
    if "z" in state:
        return np.asarray(state["z"])
    return np.stack([np.asarray(state["z0"]), np.asarray(state["z1"])])


# -- the generic chain (tests/test_generic_sharded.py) -------------------------------


def test_generic_pds_sharded_tv_equals_single_device(rng):
    shape, filt = (64, 64), _gauss(7, 1.5)
    y = _deconv_data(rng, shape, filt)
    solver = _tv_pds("t", shape, y, filt, False, max_iter=100)
    ref = solver.run_fixed(30)
    mesh = _mesh(4)
    sharded = solver.with_shardings(x=_rows(mesh), z=NamedSharding(mesh, PartitionSpec(None, "sp", None)))
    assert set(sharded.state_shardings) == {"x", "z"}
    got = sharded.run_fixed(30)
    assert torch.equal(got["x"], ref["x"]) and torch.equal(got["z"], ref["z"])
    out = sharded.postprocess(got)
    assert tuple(out["x"].shape) == shape and out["x"].device == mesh.devices[0]
    jm = _jmesh((8,), ("sp",))
    jref = _tv_pds("j", shape, y, filt, False, max_iter=100).with_shardings(
        x=JaxSharding(jm, JP("sp", None)), z=JaxSharding(jm, JP(None, "sp", None))).run_fixed(30)
    _close(got["x"], jref["x"])
    _close(got["z"], jref["z"])


def test_generic_apgd_sharded_stacked_recovery(rng):
    from pycsou_tpu.ops import DCTOperator, Masking, SubSampling
    from pycsou_tpu.ops.stack import LinOpVStack

    n = 256
    c_true = np.zeros(n, np.float32)
    c_true[rng.choice(100, 12, replace=False)] = rng.standard_normal(12).astype(np.float32)
    mask = rng.uniform(size=n) < 0.4
    jdct = DCTOperator((n,))
    jK = LinOpVStack([Masking((n,), mask), SubSampling((n,), np.arange(24)) * jdct])
    jK.compute_lipschitz_cst()
    y = np.asarray(jK(jdct.adjoint(jnp.asarray(c_true))))
    jref = jopt.APGD((n,), F=jfunc.SquaredL2Loss(jK.codim_shape, data=jnp.asarray(y)) * jK,
                     G=0.01 * (jfunc.L1Norm((n,)) * jdct), max_iter=200).run_fixed(60)

    dct = tops.DCTOperator((n,))
    K = tops.LinOpVStack([tops.Masking((n,), mask), tops.SubSampling((n,), np.arange(24)) * dct])
    K.lipschitz = float(jK.lipschitz)  # the JAX power iteration's start vector differs
    F = tfunc.SquaredL2Loss(K.codim_shape, data=y) * K
    solver = topt.APGD((n,), F=F, G=0.01 * (tfunc.L1Norm((n,)) * dct), max_iter=200)
    sh = NamedSharding(_mesh(8), PartitionSpec("sp"))
    got = solver.with_shardings(x=sh, x_temp=sh).run_fixed(60)
    assert torch.equal(got["x_temp"], solver.run_fixed(60)["x_temp"])
    _close(got["x_temp"], jref["x_temp"])


def test_sharded_solve_converges_and_matches(rng):
    shape, filt = (32, 64), _gauss(5, 1.0)
    y = _deconv_data(rng, shape, filt)
    ref = _tv_pds("j", shape, y, filt, False, max_iter=150, accuracy_threshold=1e-5).solve()
    mesh = _mesh(8)
    info = _tv_pds("t", shape, y, filt, False, max_iter=150, accuracy_threshold=1e-5).with_shardings(
        x=_rows(mesh), z=NamedSharding(mesh, PartitionSpec(None, "sp", None))).solve()
    assert info.converged == ref.converged
    _close(info["x"], ref["x"])


def test_per_variable_diagnostics(rng):
    shape, filt = (16, 16), _gauss(5, 1.0)
    y = np.abs(rng.standard_normal(shape)).astype(np.float32)
    info = _tv_pds("t", shape, y, filt, False, max_iter=40, accuracy_threshold=0.0).solve()
    assert set(info.diagnostics) == {"x", "z"}
    assert info.diagnostics["x"].shape == (info.n_iter,)
    np.testing.assert_allclose(info.diagnostics["x"], info.history, rtol=1e-6)
    assert np.isfinite(info.diagnostics["z"][5:]).all() and (info.diagnostics["z"][5:] > 0).any()
    jinfo = _tv_pds("j", shape, y, filt, False, max_iter=40, accuracy_threshold=0.0).solve()
    for k in ("x", "z"):
        np.testing.assert_allclose(info.diagnostics[k][5:], np.asarray(jinfo.diagnostics[k])[5:], rtol=1e-4)


def test_apgd_diagnostics_primary_var(rng):
    from pycsou_tpu.ops.basic import DenseOperator as JDense

    M = rng.standard_normal((20, 12)).astype(np.float32)
    xv = rng.standard_normal(12).astype(np.float32)
    A = tops.DenseOperator(M)
    A.compute_lipschitz_cst()
    jA = JDense(jnp.asarray(M))
    jA.compute_lipschitz_cst()
    A.lipschitz = float(jA.lipschitz)
    y = M @ xv
    info = topt.APGD((12,), F=tfunc.SquaredL2Loss((20,), data=y) * A, max_iter=50, accuracy_threshold=0.0).solve()
    assert "x_temp" in info.diagnostics and "x" in info.diagnostics
    np.testing.assert_allclose(info.diagnostics["x_temp"], info.history, rtol=1e-6)
    jinfo = jopt.APGD((12,), F=jfunc.SquaredL2Loss((20,), data=jnp.asarray(y)) * jA, max_iter=50,
                      accuracy_threshold=0.0).solve()
    _close(info["x"], jinfo["x"])


def test_tv_solver_with_shardings_matches_single(rng):
    """The sharded copy runs one iteration a step on the mode's first
    single-step engine (``"plain"`` on CPU tensors) and equals the JAX
    package's sharded copy (its XLA stencil); an odd count runs exactly."""
    H, W = 32, 48
    filt = _gauss(7, np.sqrt(2.0))
    y = rng.standard_normal((H, W)).astype(np.float32)
    mesh, jm = _mesh(4), _jmesh((8,), ("sp",))
    sh = topt.TVDeconvolution((H, W), y, 0.1, filt=filt, max_iter=40).with_shardings(
        x=_rows(mesh), z0=_rows(mesh), z1=_rows(mesh))
    assert sh.stencil_mode == "plain" and sh.iters_per_step == 1
    got = sh.run_fixed(40)
    jsh = jopt.TVDeconvolution((H, W), jnp.asarray(y), 0.1, filt=filt, max_iter=40).with_shardings(
        x=JaxSharding(jm, JP("sp", None)), z0=JaxSharding(jm, JP("sp", None)), z1=JaxSharding(jm, JP("sp", None)))
    _close(got["x"], jsh.run_fixed(40)["x"])
    assert sh.run_fixed(21)["it"] == 21


def test_with_shardings_keeps_kernel_plans(rng):
    """The deliberate difference from ``test_with_shardings_strips_pallas_plans``:
    the port has no GSPMD, so ``with_shardings`` keeps every operator, with
    its kernels' plans (``Convolve2D``'s band factors for K1/K2, the TV
    solver's Gram), where the reference swaps in ``_without_pallas`` twins."""
    H, W = 32, 48
    filt = _gauss(7, np.sqrt(2.0))
    y = rng.standard_normal((H, W)).astype(np.float32)
    A = tops.Convolve2D((H, W), filt)
    assert A.method == "band" and A.fwd is not None
    solver = topt.APGD((H, W), F=tfunc.SquaredL2Loss((H, W), data=y) * A, G=tfunc.NonNegativeOrthant((H, W)),
                       max_iter=5)
    sh = solver.with_shardings(x=_rows(_mesh(8)))
    assert sh.F is solver.F and sh.G is solver.G
    assert A.method == "band" and A.fwd is not None
    tv = topt.TVDeconvolution((H, W), y, 0.1, filt=filt)
    assert tv.with_shardings(x=_rows(_mesh(8))).gram is tv.gram
    assert torch.equal(sh.run_fixed(5)["x"], solver.run_fixed(5)["x"])


# -- routing onto the sharded TV solvers -------------------------------------------


def _routed_pair(shape, y, filt, tmesh, jmesh, spec, n, **kw):
    routed = _tv_pds("t", shape, y, filt, True, **kw).with_shardings(x=NamedSharding(tmesh, PartitionSpec(*spec)))
    jrouted = _tv_pds("j", shape, y, filt, True, **kw).with_shardings(x=JaxSharding(jmesh, JP(*spec)))
    return routed, routed.run_fixed(n), jrouted.run_fixed(n)


def test_sharded_pds_routes_to_distributed_engine(rng):
    shape, filt = (64, 64), _gauss(7, 1.5)
    y = _deconv_data(rng, shape, filt)
    routed, st, jst = _routed_pair(shape, y, filt, _mesh(4), _jmesh((8,), ("sp",)), ("sp", None), 30, max_iter=100)
    assert isinstance(routed._fused, parallel.DistributedTVDeconv2D) and routed.iters_per_step == 1
    assert isinstance(st["x"], tuple) and len(st["x"]) == 4
    out = routed.postprocess(st)
    assert {"x", "z"} <= set(out) and not any(isinstance(v, tuple) for v in out.values())
    _close(out["x"], jst["x"])
    _close(out["z"], _z(jst))
    info = _tv_pds("t", shape, y, filt, True, max_iter=60).with_shardings(x=_rows(_mesh(4))).solve()
    assert info.n_iter > 0 and "z" in info.iterand and tuple(info["z"].shape) == (2,) + shape
    assert set(info.diagnostics) == {"x", "z"}


def test_sharded_pds_routes_to_spatial2d_engine(rng):
    shape, filt = (64, 128), _gauss(7, 1.5)
    y = _deconv_data(rng, shape, filt)
    tm = _mesh(4, ("sp0", "sp1"), (2, 2))
    routed, st, jst = _routed_pair(shape, y, filt, tm, _jmesh((2, 4), ("sp0", "sp1")), ("sp0", "sp1"), 25,
                                   max_iter=100)
    assert isinstance(routed._fused, parallel.Spatial2DTVDeconv2D)
    _close(routed.postprocess(st)["x"], jst["x"])


def test_sharded_routing_declines_gracefully(rng, caplog):
    shape, filt = (64, 64), _gauss(7, 1.5)
    y = np.asarray(JConvolve2D(shape, jnp.asarray(filt))(jnp.ones(shape)))
    mesh = _mesh(8)
    tau_ne = _tv_pds("t", shape, y, filt, True, tau=0.1, sigma=0.05, max_iter=50)
    assert tau_ne._fused is not None
    with caplog.at_level("WARNING", logger="pycsou_tpu_torch.fuse"):
        sh1 = tau_ne.with_shardings(x=_rows(mesh))
    assert sh1._fused is None and sh1.state_shardings and "tau" in caplog.text

    def aniso(lib, fuse):
        if lib == "t":
            return topt.PDS(shape, F=tfunc.SquaredL2Loss(shape, data=y) * tops.Convolve2D(shape, filt),
                            H=0.05 * tfunc.L1Norm((2,) + shape), K=tops.Gradient(shape), max_iter=100, fuse=fuse)
        return jopt.PDS(shape, F=jfunc.SquaredL2Loss(shape, data=jnp.asarray(y)) * JConvolve2D(shape, filt),
                        H=0.05 * JL1Norm((2,) + shape), K=JGradient(shape), max_iter=100, fuse=fuse)

    a = aniso("t", True)
    assert a._fused is not None and not a._fused.iso
    sh2 = a.with_shardings(x=_rows(mesh))
    assert isinstance(sh2._fused, parallel.DistributedTVDeconv2D) and not sh2._fused.iso
    _close(sh2.postprocess(sh2.run_fixed(25))["x"], aniso("j", False).run_fixed(25)["x"])


def test_cps_delegate_sharding_declines_routing(rng):
    shape = (32, 32)
    y = rng.standard_normal(shape).astype(np.float32)

    def cps(lib, fuse):
        if lib == "t":
            return topt.CPS(shape, G=tfunc.SquaredL2Loss(shape, data=y), H=0.1 * tfunc.L21Norm((2,) + shape, axis=0),
                            K=tops.Gradient(shape), max_iter=100, fuse=fuse)
        return jopt.CPS(shape, G=jfunc.SquaredL2Loss(shape, data=jnp.asarray(y)),
                        H=0.1 * JL21Norm((2,) + shape, axis=0), K=JGradient(shape), max_iter=100, fuse=fuse)

    c = cps("t", True)
    assert c._fused is not None and c._fused.tau != c._fused.sigma
    sharded = c.with_shardings(x=_rows(_mesh(8)))
    assert sharded._fused is None and sharded.state_shardings
    got = sharded.run_fixed(25)
    assert torch.equal(got["x"], cps("t", False).run_fixed(25)["x"])
    _close(got["x"], cps("j", False).run_fixed(25)["x"])


@pytest.mark.parametrize("mesh_shape", [(8,), (2, 4)])
def test_sharded_inpainting_routes_to_mask_mode(rng, mesh_shape):
    """A fused inpainting expression routes onto the mask mode of
    ``DistributedTVDeconv2D`` (a row sharding) or ``Spatial2DTVDeconv2D``
    (a 2-D one)."""
    from pycsou_tpu.ops.sampling import Masking as JMasking

    shape = (64, 64) if len(mesh_shape) == 1 else (32, 64)
    keep = rng.random(shape) < 0.5
    y = np.asarray(JMasking(shape, keep)(jnp.asarray(np.abs(rng.standard_normal(shape)), jnp.float32)))
    names = ("sp",) if len(mesh_shape) == 1 else ("sp0", "sp1")

    def pds(lib, fuse):
        if lib == "t":
            M = tops.Masking(shape, keep)
            return topt.PDS(shape, F=tfunc.SquaredL2Loss(M.codim_shape, data=y) * M,
                            H=0.05 * tfunc.L21Norm((2,) + shape, axis=0), K=tops.Gradient(shape), max_iter=100,
                            fuse=fuse)
        M = JMasking(shape, keep)
        return jopt.PDS(shape, F=jfunc.SquaredL2Loss(M.codim_shape, data=jnp.asarray(y)) * M,
                        H=0.05 * JL21Norm((2,) + shape, axis=0), K=JGradient(shape), max_iter=100, fuse=fuse)

    mesh = _mesh(8, names, mesh_shape)
    sharded = pds("t", True).with_shardings(x=NamedSharding(mesh, PartitionSpec(*names[:2] if len(names) == 2
                                                                                     else ("sp", None))))
    want = parallel.DistributedTVDeconv2D if len(mesh_shape) == 1 else parallel.Spatial2DTVDeconv2D
    assert isinstance(sharded._fused, want) and sharded._fused.mask is not None
    _close(sharded.postprocess(sharded.run_fixed(25))["x"], pds("j", False).run_fixed(25)["x"])


def test_fused_with_shardings_drops_to_generic(rng):
    """``tests/test_fuse.py``'s: a fused PDS the sharded engines cannot take
    (tau != sigma) steps the generic expression on a 2-position mesh."""
    shape, filt = (32, 32), _gauss(5, 1.0)
    y = _deconv_data(rng, shape, filt)
    fused = _tv_pds("t", shape, y, filt, True, tau=0.08, sigma=0.05)
    assert fused._fused is not None
    mesh = _mesh(2)
    sharded = fused.with_shardings(x=_rows(mesh), z=NamedSharding(mesh, PartitionSpec(None, "sp", None)))
    assert sharded._fused is None
    st = sharded.run_fixed(30)
    _close(st["x"], _tv_pds("j", shape, y, filt, False, tau=0.08, sigma=0.05).run_fixed(30)["x"])


# -- the solvers' sharded twins --------------------------------------------------------


def test_pmyula_sharded_twin(rng, monkeypatch):
    """``tests/test_langevin.py``'s twin test: ``with_shardings`` drops the
    fused engine (K9's plain version here) for the generic chain, which
    draws the same noise, so its samples agree with the fused engine's.
    Fed the JAX chain's noise, as ``tests/test_torch_mcmc.py`` does, the
    twin's samples and moments agree with the JAX package's sharded twin
    (rtol 1e-4, atol 1e-5 scale^2)."""
    H, W = 64, 384
    y = rng.standard_normal((H, W)).astype(np.float32)
    kw = dict(seed=7, nb_burnin_iterations=2, max_iter=100)
    s = topt.PMYULA((H, W), F=tfunc.SquaredL2Loss((H, W), data=y), use_pallas="interpret", **kw)
    assert s.engine == "megal"
    twin = s._sharded_twin()
    assert twin.engine == "" and twin._lg_atb is None and s.engine == "megal"
    sh = s.with_shardings(x=_rows(_mesh(4)))
    assert sh.engine == "" and set(sh.state_shardings) == {"x"}
    st = sh.run_fixed(3)
    assert tuple(st["x"].shape) == (H, W)
    _close(st["x"], s.run_fixed(3)["x"])
    js = jopt.PMYULA((H, W), F=jfunc.SquaredL2Loss((H, W), data=jnp.asarray(y)), use_pallas="interpret", **kw)
    jt = js._without_pallas()
    assert jt.engine == ""
    n = 8
    key, xis = jax.random.PRNGKey(7), []
    for _ in range(n):  # the JAX chain's noise: its key split once per sample
        key, sub = jax.random.split(key)
        xis.append(np.array(jax.random.normal(sub, (H, W), dtype=jnp.float32)))
    monkeypatch.setattr(topt.mcmc, "normal_noise", lambda seed, i, shape, device: torch.from_numpy(xis[int(i)]))
    jst, tst = jt.run_fixed(n), s.with_shardings(x=_rows(_mesh(4))).run_fixed(n)
    scale = float(np.abs(np.asarray(jst["x"])).max())
    for k in ("x", "mmse_raw", "m2_raw"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=1e-4, atol=1e-5 * scale**2, err_msg=k)
    assert int(tst["count"]) == int(jst["count"]) > 0


def test_lasso_sharded_twins(rng):
    """``LassoDeconvolution.with_shardings`` runs the ``"gram"`` engine in
    place of megaf (K8), and ``APGD.with_shardings`` drops the fused
    delegate; both agree with the fused run and with the JAX package."""
    H, W = 32, 64
    filt = _gauss(5, 1.0)
    y = _deconv_data(rng, (H, W), filt)
    L = topt.LassoDeconvolution((H, W), y, 0.01, filt=filt, use_pallas="interpret")
    T = L.with_shardings(x=_rows(_mesh(4)))
    assert L.engine == "megaf" and T.engine == "gram"
    ref = L.run_fixed(20)
    _close(T.run_fixed(20)["x_temp"], ref["x_temp"])
    jL = jopt.LassoDeconvolution((H, W), jnp.asarray(y), 0.01, filt=filt).with_shardings(
        x=JaxSharding(_jmesh((8,), ("sp",)), JP("sp", None)))
    _close(T.run_fixed(20)["x_temp"], jL.run_fixed(20)["x_temp"])
    apgd = topt.APGD((H, W), F=tfunc.SquaredL2Loss((H, W), data=y) * tops.Convolve2D((H, W), filt),
                     G=0.01 * tfunc.L1Norm((H, W)))
    assert apgd._fused is not None
    sh = apgd.with_shardings(x=_rows(_mesh(4)))
    assert sh._fused is None
    got = sh.run_fixed(20)
    _close(got["x_temp"], ref["x_temp"])
    japgd = jopt.APGD((H, W), F=jfunc.SquaredL2Loss((H, W), data=jnp.asarray(y)) * JConvolve2D((H, W), filt),
                      G=0.01 * jfunc.L1Norm((H, W))).with_shardings(x=JaxSharding(_jmesh((8,), ("sp",)), JP("sp", None)))
    _close(got["x_temp"], japgd.run_fixed(20)["x_temp"])


# -- the port's own cases --------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape, names, spec, shape", [
    ((4,), ("sp",), ("sp", None), (8, 6)),
    ((4,), ("sp",), (None, "sp"), (3, 8)),
    ((2, 2), ("a", "b"), ("a", "b"), (4, 6)),
    ((2, 2), ("a", "b"), ("b", None), (4, 3)),
    ((2, 4), ("a", "b"), (("a", "b"), None), (16, 2)),
    ((2, 2), ("a", "b"), (), (3, 5)),
    ((4,), ("sp",), (None, "sp", None), (2, 8, 3)),
])
def test_named_sharding_split_join(rng, mesh_shape, names, spec, shape):
    """``split`` cuts a whole tensor into one block a position on its device
    (a spec that leaves a mesh axis out repeats the block along it);
    ``join`` is its inverse."""
    mesh = _mesh(int(np.prod(mesh_shape)), names, mesh_shape)
    sh = NamedSharding(mesh, PartitionSpec(*spec))
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    blocks = sh.split(t)
    assert len(blocks) == mesh.size and all(b.is_contiguous() for b in blocks)
    parts = sh.parts(len(shape))
    assert all(tuple(b.shape) == tuple(s // k for s, k in zip(shape, parts)) for b in blocks)
    assert torch.equal(sh.join(blocks), t)
    if not spec:
        assert sh.spec == parallel.replicated(mesh).spec and all(torch.equal(b, t) for b in blocks)
    if spec == ("sp", None):
        assert parallel.shard_along(mesh, "sp", 2, 0).spec == sh.spec


def test_named_sharding_rejects_an_axis_that_does_not_divide(rng):
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(mesh, PartitionSpec("sp", None)).split(torch.zeros(6, 4))
    with pytest.raises(ValueError):
        NamedSharding(mesh, PartitionSpec("nope"))
    shape, filt = (30, 32), _gauss(5, 1.0)
    y = _deconv_data(rng, shape, filt)
    sh = _tv_pds("t", shape, y, filt, False, max_iter=10).with_shardings(x=_rows(mesh))
    with pytest.raises(ValueError, match="does not divide"):
        sh.run_fixed(2)


def test_routed_state_saved_and_resumed(tmp_path, rng):
    """A routed solve checkpointed at 40 iterations and resumed by a fresh
    routed solver to 60 equals one uninterrupted 60-iteration solve."""
    shape, filt = (64, 64), _gauss(7, 1.5)
    y = _deconv_data(rng, shape, filt)
    mesh = _mesh(4)

    def routed(max_iter):
        s = _tv_pds("t", shape, y, filt, True, max_iter=max_iter, min_iter=max_iter, accuracy_threshold=0.0,
                    verbose=20)
        return s.with_shardings(x=_rows(mesh))

    first = routed(40).solve(checkpoint_dir=str(tmp_path))
    assert first.n_iter == 40 and (tmp_path / "step_40").exists()
    resumed = routed(60).solve(checkpoint_dir=str(tmp_path))
    whole = routed(60).solve()
    assert resumed.n_iter == whole.n_iter == 60
    assert torch.equal(resumed["x"], whole["x"]) and torch.equal(resumed["z"], whole["z"])


def test_routing_lets_other_errors_through(rng, monkeypatch):
    """Only the constructors' gate ``ValueError``s fall back to the generic
    chain: an error of another kind (a kernel that fails to build) reaches
    the caller."""
    shape, filt = (64, 64), _gauss(7, 1.5)
    y = _deconv_data(rng, shape, filt)

    def broken(self, *a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(parallel.DistributedTVDeconv2D, "__init__", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _tv_pds("t", shape, y, filt, True).with_shardings(x=_rows(_mesh(4)))


def test_with_shardings_needs_the_solvers_device(rng):
    shape, filt = (32, 32), _gauss(5, 1.0)
    y = _deconv_data(rng, shape, filt)
    mesh = make_mesh((2,), devices=["meta"] * 2)
    for fuse in (True, False):
        with pytest.raises(ValueError, match="meta.*cpu"):
            _tv_pds("t", shape, y, filt, fuse).with_shardings(x=_rows(mesh))
    with pytest.raises(TypeError):
        _tv_pds("t", shape, y, filt, False).with_shardings(x="sp")
