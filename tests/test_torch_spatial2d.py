"""The 2-D mesh slice of the port against the JAX package, on the CPU.

* The 2-D halo exchange (``parallel/spatial.py``: column halos, the lane
  extension, the row halos with their corners, the full extension) against
  slices of the zero-padded global array.
* K17's plain version (megar on a block of a 2-D mesh) against the JAX
  kernel ``tv_pds_megar_shard2d_step`` in interpret mode, called outside
  ``shard_map`` on a corner, an edge and an interior block with halos cut
  from the global arrays (128 lanes there, ``HALO_COLS`` = 32 columns
  here): rtol 3e-5 / atol 3e-6 (the reference's own, for one launch); the
  core's partial sums within rtol 1e-4 (f32 sums in another order).
* The blocks' plain K17 steps, joined, against K4's plain version on the
  whole image: within rtol 1e-6 (the same arithmetic).
* ``Spatial2DTVDeconv2D`` (port on a mesh of CPU devices, ``"interpret"``)
  against the JAX solver (``use_pallas="interpret"`` on the conftest's
  virtual devices) after 6 iterations on (2, 2), (1, 2), (2, 1) and (2, 4)
  meshes: x, z0, z1 within rtol 1e-4 / atol 1e-5 max|x| (A^H y by K1's
  plain version against the reference's band passes, and its bf16x3 MXU
  Grams); the metric history of ``solve()``, anisotropic TV, the engine
  path, the state carried across, ``run``/``objective`` and the refusals.
* K18's plain version (``sepgram_apply``) against the JAX kernel in
  interpret mode, rank 1 and 2, odd and even tap counts: rtol 3e-5 / atol
  3e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pycsou_tpu.kernels.sepgram import sepgram_apply as jax_sepgram_apply
from pycsou_tpu.kernels.tvr import make_megar_plan
from pycsou_tpu.kernels.tvr import tv_pds_megar_shard2d_step as jax_megar_shard2d
from pycsou_tpu.parallel.solvers import Spatial2DTVDeconv2D as JaxSpatial2D
from pycsou_tpu_torch.kernels.conv2d import SepFactors
from pycsou_tpu_torch.kernels.sepgram import sepgram_apply, sepgram_apply_plain, sepgram_available
from pycsou_tpu_torch.kernels.tvr import (
    HALO_COLS,
    tv_pds_megar_shard2d_step,
    tv_pds_megar_shard2d_step_plain,
    tv_pds_megar_step_plain,
)
from pycsou_tpu_torch.ops.conv import lowrank_factors
from pycsou_tpu_torch.parallel import (
    DistributedTVDeconv2D,
    Spatial2DTVDeconv2D,
    halo_extend_2d,
    halo_from_next_cols,
    halo_from_prev_cols,
    halos_2d,
    lane_extend,
    make_mesh,
    make_mesh_2d,
    mesh_shape_2d,
)
from pycsou_tpu_torch.parallel import solvers as port_solvers
from pycsou_tpu_torch.utils.convert import shard_state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


H, W = 128, 512
LAM = 0.05
KW = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.05, nonneg=True, iso=True)
MESHES = [(2, 2), (1, 2), (2, 1), (2, 4)]


def _gauss(K, s=2.0):
    ax = np.arange(K) - K // 2
    g = np.exp(-(ax**2) / (2 * s * s))
    return g / g.sum()


def _psf(kind):
    """The reference's test PSFs (tests/test_shard_kernels.py:189-273)."""
    if kind == "gauss7":
        return np.outer(_gauss(7), _gauss(7)).astype(np.float32)
    if kind == "rank2":
        h = np.outer(_gauss(7), _gauss(7)) + 0.35 * np.outer(_gauss(7, 0.8), _gauss(7, 3.0))
        return (h / h.sum()).astype(np.float32)
    if kind == "gauss33":
        return np.outer(_gauss(33, 4.0), _gauss(33, 4.0)).astype(np.float32)
    h = np.random.default_rng(0).random((7, 7))  # rank 7
    return (h / h.sum()).astype(np.float32)


def _jax_mesh(shape):
    return JaxMesh(np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("sp0", "sp1"))


def _mesh(shape):
    return make_mesh(shape, ("sp0", "sp1"), devices=["cpu"] * (shape[0] * shape[1]))


def _j(a):
    """A JAX copy (the JAX kernels update their inputs in place, so they
    never get the numpy arrays the port reads)."""
    return jnp.array(np.array(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _state(rng, shape=(H, W)):
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    z0 = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    z1 = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    z0[-1] = 0.0
    z1[:, -1] = 0.0
    return x, z0, z1, rng.standard_normal(shape).astype(np.float32)


def _grid(a, n0, n1):
    h, w = a.shape[0] // n0, a.shape[1] // n1
    return tuple(tuple(_t(a[i * h : (i + 1) * h, j * w : (j + 1) * w]) for j in range(n1)) for i in range(n0))


def _window(a, i, j, n0, n1, R, C):
    """Block (i, j)'s window of the global array a grown by R rows and C
    columns each side, zeros beyond the image."""
    h, w = a.shape[0] // n0, a.shape[1] // n1
    p = np.pad(a, ((R, R), (C, C)))
    return p[i * h : (i + 1) * h + 2 * R, j * w : (j + 1) * w + 2 * C]


# -- the 2-D halo exchange --------------------------------------------------------


@pytest.mark.parametrize("n1", [1, 2, 4])
def test_column_halos_match_global_slices(rng, n1):
    a = rng.standard_normal((6, 64)).astype(np.float32)
    w = 64 // n1
    row = _grid(a, 1, n1)[0]
    for c in (1, 5, w):
        prev, nxt = halo_from_prev_cols(row, c), halo_from_next_cols(row, c)
        for j in range(n1):
            win = _window(a, 0, j, 1, n1, 0, c)
            assert prev[j].is_contiguous() and nxt[j].is_contiguous()
            assert np.array_equal(prev[j].numpy(), win[:, :c]) and np.array_equal(nxt[j].numpy(), win[:, -c:])
    with pytest.raises(ValueError, match="halo columns"):
        halo_from_next_cols(row, w + 1)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 1), (2, 4), (3, 3)])
def test_lane_extension_and_row_halos_match_global_slices(rng, mesh):
    """``lane_extend`` grows each block by C columns of its row neighbours;
    ``halos_2d`` takes R rows of the column neighbours' lane-extended
    blocks, so the diagonal corners ride along; ``halo_extend_2d`` is both."""
    n0, n1 = mesh
    a, b = (rng.standard_normal((12 * n0, 10 * n1)).astype(np.float32) for _ in range(2))
    R, C = 3, 4
    ext = [lane_extend(_grid(v, n0, n1), C) for v in (a, b)]
    hl = halos_2d(ext, R)
    full = halo_extend_2d(_grid(a, n0, n1), R, C)
    for i in range(n0):
        for j in range(n1):
            wa, wb = _window(a, i, j, n0, n1, R, C), _window(b, i, j, n0, n1, R, C)
            assert np.array_equal(ext[0][i][j].numpy(), wa[R:-R]) and np.array_equal(ext[1][i][j].numpy(), wb[R:-R])
            want = [wa[:R], wa[-R:], wb[:R], wb[-R:]]
            assert len(hl[i][j]) == 4 and all(np.array_equal(g.numpy(), v) for g, v in zip(hl[i][j], want))
            assert np.array_equal(full[i][j].numpy(), wa)


def test_mesh_shape_2d_is_the_references_default(monkeypatch):
    for n in range(1, 17):
        n0 = int(np.floor(np.sqrt(n)))
        while n % n0:
            n0 -= 1
        assert mesh_shape_2d(n) == (n0, n // n0)
    m = make_mesh_2d(devices=["cpu"] * 8)
    assert m.shape == (2, 4) and m.axis_names == ("sp0", "sp1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh_2d()


# -- K17's plain version against the JAX block kernel ------------------------------


def _block_args(arrays, i, j, mesh, R, C):
    """(x_ext, z0_ext, z1_ext, atb_ext, halos) of block (i, j) cut from the
    global arrays with C halo columns and R halo rows."""
    n0, n1 = mesh
    x, z0, z1, a = (_window(v, i, j, n0, n1, R, C) for v in arrays)
    hal = tuple(t for v in (x, z0, z1) for t in (v[:R], v[-R:]))
    return x[R:-R], z0[R:-R], z1[R:-R], a, hal


@pytest.mark.parametrize("mesh,block", [((2, 4), (0, 0)), ((2, 4), (1, 2)), ((4, 4), (1, 2))],
                         ids=["corner", "edge", "interior"])
@pytest.mark.parametrize("psf", ["gauss7", "rank2"])
def test_block_plain_matches_pallas(rng, psf, mesh, block):
    """K17: the wrapper's CPU route against the Pallas block kernel in
    interpret mode, 128 lanes there and HALO_COLS columns here.  Each side
    runs twice and must give the same bits both times, so that a failure
    names the side whose result moved: the port's first call runs after
    JAX's first result is ready, its second while JAX's second call may
    still be running (JAX dispatches asynchronously)."""
    arrays = _state(rng)
    (n0, n1), (i, j) = mesh, block
    h, w, R, C, L = H // n0, W // n1, 32, HALO_COLS, 128
    filt = _psf(psf)
    us, vs = lowrank_factors(filt)
    # the JAX solver's band plan for this block (solvers.py:1127-1132)
    *plan, tile = make_megar_plan(us, vs, (h + 2 * R, max(w + 2 * L, 384)))
    assert tile == R
    jx, jz0, jz1, ja, jhal = _block_args(arrays, i, j, mesh, R, L)
    f = SepFactors(us, vs, filt.shape[0] // 2, filt.shape[1] // 2, "cpu")
    x, z0, z1, a, hal = _block_args(arrays, i, j, mesh, R, C)

    def jax_side():
        return jax_megar_shard2d(_j(jx), _j(jz0), _j(jz1), _j(ja), tuple(_j(b) for b in jhal), *plan,
                                 jnp.asarray([i * h - R, j * w - L], jnp.int32), H_global=H, W_global=W,
                                 mega_r=R, interpret=True, **KW)

    def port_side():
        out = tv_pds_megar_shard2d_step(_t(x), _t(z0), _t(z1), _t(a), tuple(_t(b) for b in hal), f,
                                        f.adjoint(2.0), (i * h - R, j * w - C), H_global=H, W_global=W, **KW)
        return [v.numpy().copy() for v in out]

    numpy_of = lambda out: [np.asarray(v) for v in jax.block_until_ready(out)]  # noqa: E731
    want = numpy_of(jax_side())
    got = port_side()
    pending = jax_side()
    got2 = port_side()
    want2 = numpy_of(pending)
    assert tv_pds_megar_shard2d_step.launches == 0  # CPU tensors: the plain version
    for side, first, second in (("the JAX kernel", want, want2), ("the port's plain route", got, got2)):
        for name, u, v in zip(("x", "z0", "z1", "stats"), first, second):
            assert np.array_equal(u, v), (
                f"{side} gave two results for {name} on the same inputs: max abs difference "
                f"{np.max(np.abs(u - v)):.3e} at {np.count_nonzero(u != v)} of {u.size} elements")
    for g, wv in zip(got[:3], want[:3]):
        assert g.shape == (h, w)
        _close(g, wv, 3e-5, 3e-6)
    _close(got[3], np.asarray(want[3])[0, :6], 1e-4, 1e-6)


@pytest.mark.parametrize("mesh", MESHES + [(4, 4)])
@pytest.mark.parametrize("psf,iso", [("gauss7", True), ("rank2", False)])
def test_block_steps_join_to_the_single_device_engine(rng, mesh, psf, iso):
    """The plain K17 steps of every block (halos from the exchange), joined,
    equal K4's plain version on the whole image; their partial sums add up
    to its."""
    n0, n1 = mesh
    h, w, R, C = H // n0, W // n1, 32, HALO_COLS
    kw = dict(KW, iso=iso)
    x, z0, z1, a = _state(rng)
    us, vs = lowrank_factors(_psf(psf))
    f = SepFactors(us, vs, 3, 3, "cpu")
    adj2 = f.adjoint(2.0)
    ext = [lane_extend(_grid(v, n0, n1), C) for v in (x, z0, z1)]
    hl, aext = halos_2d(ext, R), halo_extend_2d(_grid(a, n0, n1), R, C)
    outs = [[tv_pds_megar_shard2d_step_plain(ext[0][i][j], ext[1][i][j], ext[2][i][j], aext[i][j], hl[i][j], f,
                                             adj2, (i * h - R, j * w - C), H_global=H, W_global=W, **kw)
             for j in range(n1)] for i in range(n0)]
    want = tv_pds_megar_step_plain(_t(x), _t(z0), _t(z1), _t(a), f, adj2, **kw)
    for k in range(3):
        _close(torch.cat([torch.cat([o[k] for o in row], dim=1) for row in outs]), want[k], 1e-6, 1e-7)
    _close(sum(o[3] for row in outs for o in row), want[3], 1e-5, 0)


def test_block_kernel_checks_its_inputs(rng):
    x, z0, z1, a = (_t(v) for v in _state(rng, (64, 128 + 2 * HALO_COLS)))
    us, vs = lowrank_factors(_psf("gauss7"))
    f = SepFactors(us, vs, 3, 3, "cpu")
    hal = tuple(torch.zeros(8, x.shape[1]) for _ in range(6))
    ext = torch.zeros(80, x.shape[1])
    kw = dict(KW, H_global=H, W_global=W)
    args = (x, z0, z1, ext, hal, f, f.adjoint(2.0))
    with pytest.raises(ValueError, match="reads 7 rows"):
        tv_pds_megar_shard2d_step(*args[:4], tuple(t[:4] for t in hal), *args[5:], (-4, -HALO_COLS), **kw)
    with pytest.raises(ValueError, match="6 halo blocks"):
        tv_pds_megar_shard2d_step(*args[:4], hal[:4], *args[5:], (-8, -HALO_COLS), **kw)
    with pytest.raises(ValueError, match="atb_ext"):
        tv_pds_megar_shard2d_step(x, z0, z1, ext[:70], hal, *args[5:], (-8, -HALO_COLS), **kw)
    with pytest.raises(ValueError, match="core columns"):
        tv_pds_megar_shard2d_step(*args, (-8, W - 64), **kw)
    with pytest.raises(ValueError, match="core rows"):
        tv_pds_megar_shard2d_step(*args, (H - 32, -HALO_COLS), **kw)


# -- the solver against the JAX solver -----------------------------------------------


def _problem(rng, shape=(H, W)):
    return np.abs(rng.standard_normal(shape)).astype(np.float32)


def _pair(rng, psf, mesh, **kw):
    filt, y = _psf(psf), _problem(rng)
    j = JaxSpatial2D((H, W), filt, _j(y), LAM, mesh=_jax_mesh(mesh), use_pallas="interpret", **kw)
    t = Spatial2DTVDeconv2D((H, W), filt, y, LAM, mesh=_mesh(mesh), use_pallas="interpret", **kw)
    return j, t


def _assert_state_close(tstate, jstate):
    scale = max(1.0, float(np.abs(np.asarray(jstate["x"])).max()))
    out = state_to_numpy(tstate)
    for k in ("x", "z0", "z1"):
        _close(out[k], np.asarray(jstate[k]), 1e-4, 1e-5 * scale)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("psf", ["gauss7", "rank2"])
def test_spatial2d_matches_jax(rng, psf, mesh):
    j, t = _pair(rng, psf, mesh)
    assert j._sp_engine == t._sp_engine == "megar2d" and t.rank == j.rank
    assert t.tau == pytest.approx(j.tau, rel=1e-12) and t.sigma == pytest.approx(j.sigma, rel=1e-12)
    ts, js = t.run_fixed(6), j.run_fixed(6)
    assert ts["it"] == int(js["it"]) == 6
    assert len(ts["x"]) == mesh[0] and all(len(row) == mesh[1] for row in ts["x"])
    assert all(b.shape == (H // mesh[0], W // mesh[1]) for row in ts["x"] for b in row)
    _assert_state_close(ts, js)
    _close(ts["history"][:6].numpy(), np.asarray(js["history"])[:6], 1e-4, 0)


@pytest.mark.parametrize("mesh,kernel", [((2, 2), "K17"), ((1, 4), "K17"), ((4, 1), "K15"), ((2, 1), "K15")])
def test_block_kernel_per_mesh(rng, monkeypatch, mesh, kernel):
    """One block kernel call per block and iteration: K17 when the columns
    are cut, else the row-shard kernel K15 (the reference's 1-D kernel
    path)."""
    calls = {"K17": 0, "K15": 0}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(port_solvers, "tv_pds_megar_shard2d_step",
                        counting("K17", port_solvers.tv_pds_megar_shard2d_step))
    monkeypatch.setattr(port_solvers, "tv_pds_megar_shard_step", counting("K15", port_solvers.tv_pds_megar_shard_step))
    t = Spatial2DTVDeconv2D((H, W), _psf("gauss7"), _problem(rng), LAM, mesh=_mesh(mesh), use_pallas="interpret")
    t.run_fixed(3)
    assert calls[kernel] == 3 * mesh[0] * mesh[1] and sum(calls.values()) == calls[kernel]


def test_solve_metric_and_diagnostics_match_jax(rng):
    """solve() driven by the summed partial sums: the metric history and the
    per-variable diagnostics against the JAX solver's."""
    kw = dict(max_iter=12, min_iter=3, accuracy_threshold=0.0)
    j, t = _pair(rng, "gauss7", (2, 2), **kw)
    ti, ji = t.solve(), j.solve()
    assert ti.n_iter == ji.n_iter == 12
    _close(ti.history, ji.history, 1e-3, 0)
    assert set(ti.diagnostics) == set(ji.diagnostics) == {"x", "z0", "z1"}
    for k in ("z0", "z1"):
        _close(ti.diagnostics[k][1:], ji.diagnostics[k][1:], 1e-3, 0)
    assert ti["x"].shape == (H, W)  # joined on the first mesh device
    _close(ti["x"], np.asarray(ji["x"]), 1e-4, 2e-5)


def test_anisotropic_matches_jax(rng):
    j, t = _pair(rng, "rank2", (2, 2), isotropic=False)
    _assert_state_close(t.run_fixed(6), j.run_fixed(6))


def test_run_and_objective_match_jax(rng):
    j, t = _pair(rng, "gauss7", (2, 2))
    tx, tz = t.run(4)
    jx, jz = j.run(4)
    assert tx.shape == (H, W) and tz.shape == (2, H, W)
    _close(tx, np.asarray(jx), 1e-4, 1e-5)
    _close(tz, np.asarray(jz), 1e-4, 1e-5)
    tx2, _ = t.run(2, x=tx, z=tz)
    jx2, _ = j.run(2, x=jx, z=jz)
    _close(tx2, np.asarray(jx2), 1e-4, 1e-5)
    # the reference scores the data term by the Gram identity <x, A^H A x> -
    # 2 <x, A^H y> + ||y||^2, which subtracts f32 sums; the port the residual
    _close(t.objective(tx), j.objective(_j(tx.numpy())), 3e-5, 0)
    _close(t.objective(t.initial_state()["x"]), t.objective(torch.zeros(H, W)), 0, 0)


def test_jax_state_continues_in_the_port(rng):
    """A JAX solve continued in the port for 6 more iterations matches the
    JAX solve run for 12; the port's grid of blocks goes back to the JAX
    layout."""
    j, t = _pair(rng, "gauss7", (2, 4))
    warm = {k: np.array(v) for k, v in j.run_fixed(6).items()}
    ts = shard_state_from_numpy(warm, t.mesh)
    assert len(ts["x"]) == 2 and len(ts["x"][0]) == 4 and ts["x"][1][3].shape == (H // 2, W // 4)
    assert ts["it"] == 6 and ts["_stats"].shape == (6,)
    back = state_to_numpy(ts)
    for k, v in warm.items():
        assert np.array_equal(back[k], v, equal_nan=True), k
    ts = t.run_fixed(6, state=ts)
    js = j.run_fixed(12)
    assert ts["it"] == 12
    _assert_state_close(ts, js)
    _close(ts["history"][:12].numpy(), np.asarray(js["history"])[:12], 1e-3, 0)


# -- the refusals ------------------------------------------------------------------


def test_refusals(rng):
    """The reference's errors, and the engine each former refusal now
    picks: the chain where no block kernel runs (``use_pallas=False``,
    ``"auto"`` on CPU devices, mask mode, more than 31 taps, blocks under
    32 rows or columns), as the JAX solver does."""
    y = np.zeros((H, W), np.float32)
    g = _psf("gauss7")

    def engines(shape, filt, mesh, use_pallas="auto", mask=None):
        kw = dict(mesh=_mesh(mesh), use_pallas=use_pallas, mask=mask)
        t = Spatial2DTVDeconv2D(shape, filt, np.zeros(shape, np.float32), LAM, **kw)
        if mesh[0] * mesh[1] > 8:  # the conftest's JAX mesh has 8 devices
            return t._sp_engine
        j = JaxSpatial2D(shape, filt, jnp.zeros(shape), LAM, mesh=_jax_mesh(mesh), use_pallas=use_pallas,
                         mask=None if mask is None else _j(mask))
        return t._sp_engine, j._sp_engine

    assert engines((H, W), g, (2, 2), use_pallas=False) == ("", "")
    assert engines((H, W), g, (2, 2)) == ("", "")  # "auto" on CPU devices
    with pytest.raises(ValueError, match="CPU meshes"):
        Spatial2DTVDeconv2D((H, W), g, y, LAM, mesh=_mesh((2, 2)), use_pallas=True)
    # mask mode: the chain; use_pallas=True on CPU devices raises before the
    # mode is looked at
    assert engines((H, W), None, (2, 2), use_pallas="interpret", mask=np.ones((H, W), np.float32)) == ("", "")
    with pytest.raises(ValueError, match="CPU meshes"):
        Spatial2DTVDeconv2D((H, W), None, y, LAM, mesh=_mesh((2, 2)), use_pallas=True, mask=np.ones((H, W)))
    with pytest.raises(ValueError, match="pass filt=None"):
        Spatial2DTVDeconv2D((H, W), g, y, LAM, mesh=_mesh((2, 2)), use_pallas="interpret", mask=np.ones((H, W)))
    # the reference's checks: rank <= 4, the block size, the mesh, and a
    # rank > 1 PSF that megar2d does not take
    with pytest.raises(ValueError, match="rank <= 4"):
        Spatial2DTVDeconv2D((H, W), _psf("full"), y, LAM, mesh=_mesh((2, 2)), use_pallas="interpret")
    with pytest.raises(ValueError, match="too small"):
        Spatial2DTVDeconv2D((H, W), g, y, LAM, mesh=_mesh((32, 1)), use_pallas="interpret")
    with pytest.raises(ValueError, match="2-D"):
        Spatial2DTVDeconv2D((H, W), g, y, LAM, mesh=make_mesh((4,), devices=["cpu"] * 4), use_pallas="interpret")
    with pytest.raises(ValueError, match="divide"):
        Spatial2DTVDeconv2D((H, W), g, y, LAM, mesh=_mesh((3, 1)), use_pallas="interpret")
    with pytest.raises(ValueError, match="megar2d"):
        Spatial2DTVDeconv2D((H, W), _psf("rank2"), y, LAM, mesh=_mesh((2, 2)), use_pallas=False)
    # what the block kernels cannot take: more than 31 taps, short blocks -> the chain
    assert engines((256, W), _psf("gauss33"), (2, 2), use_pallas="interpret")[0] == ""
    assert engines((H, W), g, (8, 1), use_pallas="interpret") == ("", "")
    assert engines((H, W), g, (1, 32), use_pallas="interpret") == ""
    # the 1-D solver names this one for a (rows, cols) mesh
    with pytest.raises(ValueError, match="Spatial2DTVDeconv2D"):
        DistributedTVDeconv2D((H, W), g, y, LAM, mesh=_mesh((2, 2)), use_pallas="interpret")


# -- K18: sepgram_apply --------------------------------------------------------------


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("K0,K1", [(7, 7), (6, 4), (5, 8)])
def test_sepgram_plain_matches_pallas(rng, rank, K0, K1):
    """K18: the wrapper's CPU route against the Pallas kernel in interpret
    mode, odd and even tap counts (the even ones' offsets differ either
    side)."""
    u, v = rng.random((rank, K0)) + 0.1, rng.random((rank, K1)) + 0.1
    us = tuple(tuple(float(t) for t in r / r.sum()) for r in u)  # a blur: taps summing to 1
    vs = tuple(tuple(float(t) for t in r / r.sum()) for r in v)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    want = jax_sepgram_apply(_j(x), us, vs, interpret=True)
    got = sepgram_apply(_t(x), us, vs)
    assert sepgram_apply.launches == 0 and got.shape == (64, 256)
    _close(got, want, 3e-5, 3e-6)
    assert torch.equal(got, sepgram_apply_plain(_t(x), us, vs))


def test_sepgram_checks_its_taps(rng):
    assert sepgram_available()
    x = _t(rng.standard_normal((16, 16)))
    with pytest.raises(ValueError, match="one tap tuple per rank"):
        sepgram_apply(x, ((1.0, 2.0),), ((1.0,), (2.0,)))
    with pytest.raises(ValueError, match="one tap tuple per rank"):
        sepgram_apply(x, ((1.0, 2.0), (1.0,)), ((1.0,), (2.0,)))
    with pytest.raises(ValueError, match="at most 31"):
        sepgram_apply(x, (tuple(np.ones(33)),), ((1.0,),))
