"""The sharded solvers' chain of operators against the JAX package, on the CPU.

* Each ``parallel/spatial.py`` operator on 4 row shards (a (2, 2) grid for
  the 2-D mesh's) against its JAX counterpart run under ``shard_map`` on 4
  of the conftest's virtual devices: rtol 1e-4, atol 1e-5 max|out|; each
  adjoint pair by the dot test (rtol 1e-4).
* ``DistributedTVDeconv2D`` on the chain (``use_pallas=False`` and
  ``"auto"`` on CPU devices: the band Gram, the fused FFT Gram, the FFT
  forward and adjoint, mask mode) and on sweepsp over the sharded Gram (a
  full-rank and a rank-6 PSF, ``"interpret"``: K16's plain version),
  ``Spatial2DTVDeconv2D`` in mask mode and on the rank-1 chain, and
  ``BatchedDistributedTVDeconv2D`` on a (2, 2) mesh, each against the JAX
  solver after a few iterations: x and the duals within rtol 1e-4 / atol
  1e-5 max|x|, the metric history within rtol 1e-4; the objective within
  rtol 1e-5; the engine each picks against the JAX solver's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from pycsou_tpu.kernels.band import make_band_blocks
from pycsou_tpu.kernels.band import make_gram_band as jax_make_gram_band
from pycsou_tpu.parallel import spatial as js
from pycsou_tpu.parallel.solvers import BatchedDistributedTVDeconv2D as JaxBatched
from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D as JaxDistributed
from pycsou_tpu.parallel.solvers import Spatial2DTVDeconv2D as JaxSpatial2D
from pycsou_tpu_torch.kernels.band import make_gram_band
from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_shard_step
from pycsou_tpu_torch.parallel import (
    BatchedDistributedTVDeconv2D,
    DistributedTVDeconv2D,
    Spatial2DTVDeconv2D,
    make_mesh,
    spatial,
)
from pycsou_tpu_torch.utils.convert import shard_state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


LAM = 0.05
N_IT = 8


def _gauss(K, s=1.5):
    ax = np.arange(K) - K // 2
    g = np.exp(-(ax**2) / (2 * s * s))
    return g / g.sum()


def _psf(kind):
    if kind == "gauss7":
        return np.outer(_gauss(7), _gauss(7)).astype(np.float32)
    if kind == "gauss5x3":
        return np.outer(_gauss(5), _gauss(3, 0.8)).astype(np.float32)
    if kind == "rank2":
        h = np.outer(_gauss(5), _gauss(5)) + 0.4 * np.outer(_gauss(5, 0.8), _gauss(5, 3.0))
        return (h / h.sum()).astype(np.float32)
    if kind == "rank6":  # bench.py sec_rank6's kind: 6 random outer products
        r = np.random.default_rng(11)
        h = r.standard_normal((11, 6)) @ r.standard_normal((11, 6)).T
        return (h / np.abs(h).sum()).astype(np.float32)
    if kind == "full9":
        h = np.random.default_rng(5).random((9, 9))
        return (h / h.sum()).astype(np.float32)
    h = np.random.default_rng(3).random((7, 7))  # "full7"
    return (h / h.sum()).astype(np.float32)


def _mesh(n):
    return make_mesh((n,), devices=["cpu"] * n)


def _jmesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("sp",))


def _jmesh2():
    return JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("sp0", "sp1"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(1.0, float(np.abs(want).max())))


def _rows(a, n=4):
    """The (..., H, W) array as n row shards."""
    h = a.shape[-2] // n
    return tuple(_t(a[..., i * h : (i + 1) * h, :]) for i in range(n))


def _grid(a):
    """The (..., H, W) array as a (2, 2) grid of blocks."""
    h, w = a.shape[-2] // 2, a.shape[-1] // 2
    return tuple(tuple(_t(a[..., i * h : (i + 1) * h, j * w : (j + 1) * w]) for j in range(2)) for i in range(2))


def _join_rows(blocks):
    return np.concatenate([b.numpy() for b in blocks], axis=-2)


def _join_grid(grid):
    return np.concatenate([np.concatenate([b.numpy() for b in row], axis=-1) for row in grid], axis=-2)


def _jax_rows(fn, a, n=4, out_lead=()):
    """``fn(block, "sp")`` under shard_map on n devices, rows sharded."""
    lead = (None,) * (a.ndim - 2)
    out = (None,) * len(out_lead)
    f = jax.shard_map(lambda b: fn(b, "sp"), mesh=_jmesh(n), in_specs=P(*lead, "sp", None),
                      out_specs=P(*out, "sp", None))
    return np.asarray(jax.jit(f)(jnp.asarray(a)))


def _jax_grid(fn, a, out_lead=()):
    lead = (None,) * (a.ndim - 2)
    out = (None,) * len(out_lead)
    f = jax.shard_map(lambda b: fn(b, "sp0", "sp1"), mesh=_jmesh2(), in_specs=P(*lead, "sp0", "sp1"),
                      out_specs=P(*out, "sp0", "sp1"))
    return np.asarray(jax.jit(f)(jnp.asarray(a)))


def _dot(a, b):
    return float(np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64)))


# -- the sharded operators -----------------------------------------------------------


H1, W1 = 64, 48  # four 16-row shards


@pytest.mark.parametrize("op", ["fdiff_rows", "grad2d", "conv2d", "conv2d_gram", "sepgram_rank1"])
def test_row_sharded_operator_matches_jax(rng, op):
    x = rng.standard_normal((H1, W1)).astype(np.float32)
    y = rng.standard_normal((2, H1, W1) if op == "grad2d" else (H1, W1)).astype(np.float32)
    h = _psf("gauss5x3") if op == "sepgram_rank1" else _psf("full7")
    jh = jnp.asarray(h)
    if op == "fdiff_rows":
        fwd, adj = spatial.sharded_fdiff_rows, spatial.sharded_fdiff_rows_adjoint
        jfwd, jadj = js.sharded_fdiff_rows, js.sharded_fdiff_rows_adjoint
    elif op == "grad2d":
        fwd, adj = spatial.sharded_grad2d, spatial.sharded_grad2d_adjoint
        jfwd, jadj = js.sharded_grad2d, js.sharded_grad2d_adjoint
    elif op == "conv2d":
        fwd = lambda b: spatial.sharded_conv2d(b, _t(h))  # noqa: E731
        adj = lambda b: spatial.sharded_conv2d_adjoint(b, _t(h))  # noqa: E731
        jfwd = lambda b, ax: js.sharded_conv2d(b, jh, ax)  # noqa: E731
        jadj = lambda b, ax: js.sharded_conv2d_adjoint(b, jh, ax)  # noqa: E731
    elif op == "conv2d_gram":
        fwd = adj = lambda b: spatial.sharded_conv2d_gram(b, _t(h))  # noqa: E731
        jfwd = jadj = lambda b, ax: js.sharded_conv2d_gram(b, jh, ax)  # noqa: E731
    else:
        u, v = _gauss(5), _gauss(3, 0.8)

        def plans(taps, n):
            a, et, eb, L = make_gram_band(taps, n)
            cast = lambda e: None if e is None else _t(e)  # noqa: E731
            return _t(a), cast(et), cast(eb), L

        gr, gc = plans(u, H1), plans(v, W1)
        jr, jc = jax_make_gram_band(u, H1), jax_make_gram_band(v, W1)
        fwd = adj = lambda b: spatial.sharded_sepgram_rank1(b, gr, gc)  # noqa: E731
        jfwd = jadj = lambda b, ax: js.sharded_sepgram_rank1(b, jr, jc, ax)  # noqa: E731
    got = _join_rows(fwd(_rows(x)))
    want = _jax_rows(jfwd, x, out_lead=(2,) if op == "grad2d" else ())
    _close(got, want)
    if op in ("conv2d_gram", "sepgram_rank1"):  # the Gram: A^H A of the global operator
        from pycsou_tpu_torch.ops import Convolve2D

        conv = Convolve2D((H1, W1), h, method="fft", device="cpu")
        _close(got, conv.adjoint(conv.apply(_t(x))).numpy())
    back = _join_rows(adj(_rows(y)))
    _close(back, _jax_rows(jadj, y))
    # the dot test of the adjoint pair
    np.testing.assert_allclose(_dot(got, y), _dot(x, back), rtol=1e-4)


@pytest.mark.parametrize("op", ["fdiff_cols", "grad2d_2d", "sepconv2d_2d", "sepgram_rank1_2d"])
def test_grid_operator_matches_jax(rng, op):
    Hg, Wg = 48, 64
    x = rng.standard_normal((Hg, Wg)).astype(np.float32)
    y = rng.standard_normal((2, Hg, Wg) if op == "grad2d_2d" else (Hg, Wg)).astype(np.float32)
    u, v = _gauss(5), _gauss(3, 0.8)
    if op == "fdiff_cols":
        fwd, adj = spatial.sharded_fdiff_cols, spatial.sharded_fdiff_cols_adjoint
        jfwd = lambda b, r, c: js.sharded_fdiff_cols(b, c)  # noqa: E731
        jadj = lambda b, r, c: js.sharded_fdiff_cols_adjoint(b, c)  # noqa: E731
    elif op == "grad2d_2d":
        fwd, adj = spatial.sharded_grad2d_2d, spatial.sharded_grad2d_adjoint_2d
        jfwd, jadj = js.sharded_grad2d_2d, js.sharded_grad2d_adjoint_2d
    elif op == "sepconv2d_2d":
        pf = ((_t(u), 2), (_t(v), 1))
        pa = ((_t(u[::-1]), 2), (_t(v[::-1]), 1))
        fwd = lambda g: spatial.sharded_sepconv2d_2d(g, *pf)  # noqa: E731
        adj = lambda g: spatial.sharded_sepconv2d_adjoint_2d(g, *pa)  # noqa: E731
        jpf = ((make_band_blocks(u, 2), 4), (make_band_blocks(v, 1), 2))
        jpa = ((make_band_blocks(u[::-1], 2), 4), (make_band_blocks(v[::-1], 1), 2))
        jfwd = lambda b, r, c: js.sharded_sepconv2d_2d(b, *jpf, r, c)  # noqa: E731
        jadj = lambda b, r, c: js.sharded_sepconv2d_adjoint_2d(b, *jpa, r, c)  # noqa: E731
    else:
        def plans(taps, n):
            a, et, eb, L = make_gram_band(taps, n)
            cast = lambda e: None if e is None else _t(e)  # noqa: E731
            return _t(a), cast(et), cast(eb), L

        gr, gc = plans(u, Hg), plans(v, Wg)
        jr, jc = jax_make_gram_band(u, Hg), jax_make_gram_band(v, Wg)
        fwd = adj = lambda g: spatial.sharded_sepgram_rank1_2d(g, gr, gc)  # noqa: E731
        jfwd = jadj = lambda b, r, c: js.sharded_sepgram_rank1_2d(b, jr, jc, r, c)  # noqa: E731
    got = _join_grid(fwd(_grid(x)))
    _close(got, _jax_grid(jfwd, x, out_lead=(2,) if op == "grad2d_2d" else ()))
    back = _join_grid(adj(_grid(y)))
    _close(back, _jax_grid(jadj, y))
    np.testing.assert_allclose(_dot(got, y), _dot(x, back), rtol=1e-4)


def test_pdot_pnorm(rng):
    a, b = (rng.standard_normal((H1, W1)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(spatial.pdot(_rows(a), _rows(b))), _dot(a, b), rtol=1e-5)
    np.testing.assert_allclose(float(spatial.pnorm(_rows(a))), np.linalg.norm(a.astype(np.float64)), rtol=1e-5)


# -- DistributedTVDeconv2D on the chain and on sweepsp over the Gram -------------------


# kind -> (shape, P, PSF or "mask", use_pallas, the port's engine, the route of
# the data gradient: band, gram (the fused FFT Gram), fwdadj or mask)
_DIST = {
    "band": ((64, 48), 4, "gauss5x3", False, "", "band"),
    "fft gram": ((64, 48), 4, "full7", False, "", "gram"),
    "fwd+adj": ((32, 48), 4, "full9", False, "", "fwdadj"),
    "mask": ((64, 48), 4, "mask", False, "", "mask"),
    "auto on cpu": ((64, 48), 2, "full7", "auto", "", "gram"),
    "sweepsp full rank": ((128, 64), 4, "full7", "interpret", "sweepsp", "gram"),
    "sweepsp rank 6": ((128, 64), 4, "rank6", "interpret", "sweepsp", "gram"),
}


def _dist_problem(rng, shape, psf):
    y = np.abs(rng.standard_normal(shape)).astype(np.float32)
    if psf == "mask":
        m = (rng.random(shape) < 0.7).astype(np.float32)
        return None, m * y, m
    return _psf(psf), y, None


def _dist_pair(rng, kind, **kw):
    shape, n, psf, use_pallas, _, _ = _DIST[kind]
    filt, y, mask = _dist_problem(rng, shape, psf)
    j = JaxDistributed(shape, filt, jnp.asarray(y), LAM, mesh=_jmesh(n), use_pallas=use_pallas,
                       mask=None if mask is None else jnp.asarray(mask), **kw)
    t = DistributedTVDeconv2D(shape, filt, y, LAM, mesh=_mesh(n), use_pallas=use_pallas, mask=mask, **kw)
    return j, t


def _assert_state_close(tstate, jstate, keys):
    out = state_to_numpy(tstate)
    scale = max(1.0, float(np.abs(np.asarray(jstate["x"])).max()))
    for k in keys:
        np.testing.assert_allclose(out[k], np.asarray(jstate[k]), rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("kind", list(_DIST))
def test_distributed_chain_matches_jax(rng, kind):
    j, t = _dist_pair(rng, kind)
    route = _DIST[kind][5]
    assert t._sp_engine == j._sp_engine == _DIST[kind][4]
    assert (t._use_band, t._use_gram) == (j._use_band, j._use_gram)
    assert {"band": t._use_band, "gram": not t._use_band and t._use_gram,
            "fwdadj": not t._use_gram, "mask": t.mask is not None}[route]
    assert t.tau == pytest.approx(j.tau, rel=1e-12)
    n0 = tv_pds_sweep_shard_step.launches
    ts, js_ = t.run_fixed(N_IT), j.run_fixed(N_IT)
    assert tv_pds_sweep_shard_step.launches == n0  # CPU tensors: the plain version, no launch
    _close(state_to_numpy({"atb": t.atb})["atb"], np.asarray(j.atb))
    keys = ("x", "z") if not t._sp_engine else ("x", "z0", "z1")
    assert set(keys) <= set(ts)
    _assert_state_close(ts, js_, keys)
    np.testing.assert_allclose(ts["history"][:N_IT].numpy(), np.asarray(js_["history"])[:N_IT], rtol=1e-4)
    x = state_to_numpy(ts)["x"]
    np.testing.assert_allclose(float(t.objective(ts["x"])), float(j.objective(jnp.asarray(x))), rtol=1e-5)


def test_distributed_chain_solve_diagnostics_and_run(rng):
    kw = dict(max_iter=12, min_iter=3, accuracy_threshold=0.0)
    j, t = _dist_pair(rng, "band", **kw)
    ti, ji = t.solve(), j.solve()
    assert ti.n_iter == ji.n_iter == 12
    np.testing.assert_allclose(ti.history, ji.history, rtol=1e-4)
    assert set(ti.diagnostics) == set(ji.diagnostics) == {"x", "z"}
    np.testing.assert_allclose(ti.diagnostics["z"][1:], ji.diagnostics["z"][1:], rtol=1e-4)
    assert ti["x"].shape == (64, 48) and ti["z"].shape == (2, 64, 48)
    _close(ti["z"], np.asarray(ji["z"]))
    tx, tz = t.run(3)
    jx, jz = j.run(3)
    _close(tx, np.asarray(jx))
    _close(tz, np.asarray(jz))
    assert len(t.z0) == 4 and t.z0[0].shape == (2, 16, 48)


def test_jax_chain_state_continues_in_the_port(rng):
    """A JAX chain state (a stacked z) cut into the port's shards, continued:
    it matches the JAX run for as many iterations in all."""
    j, t = _dist_pair(rng, "fft gram")
    warm = {k: np.array(v) for k, v in j.run_fixed(4).items()}
    ts = shard_state_from_numpy(warm, t.mesh)
    assert len(ts["z"]) == 4 and ts["z"][0].shape == (2, 16, 48)
    ts = t.run_fixed(4, state=ts)
    _assert_state_close(ts, j.run_fixed(8), ("x", "z"))


# -- Spatial2DTVDeconv2D: mask mode and the rank-1 chain ---------------------------------


def _mesh2():
    return make_mesh((2, 2), ("sp0", "sp1"), devices=["cpu"] * 4)


@pytest.mark.parametrize("kind", ["mask", "rank1 chain", "rank1 interpret small blocks"])
def test_spatial2d_chain_matches_jax(rng, kind):
    shape = (48, 64) if kind != "rank1 interpret small blocks" else (40, 48)
    use_pallas = "interpret" if kind == "rank1 interpret small blocks" else False
    filt, y, mask = _dist_problem(rng, shape, "mask" if kind == "mask" else "gauss5x3")
    j = JaxSpatial2D(shape, filt, jnp.asarray(y), LAM, mesh=_jmesh2(), use_pallas=use_pallas,
                     mask=None if mask is None else jnp.asarray(mask))
    t = Spatial2DTVDeconv2D(shape, filt, y, LAM, mesh=_mesh2(), use_pallas=use_pallas, mask=mask)
    assert t._sp_engine == j._sp_engine == ""
    _close(state_to_numpy({"atb": t.atb})["atb"], np.asarray(j.atb))
    ts, js_ = t.run_fixed(N_IT), j.run_fixed(N_IT)
    _assert_state_close(ts, js_, ("x", "z"))
    np.testing.assert_allclose(ts["history"][:N_IT].numpy(), np.asarray(js_["history"])[:N_IT], rtol=1e-4)
    x = state_to_numpy(ts)["x"]
    np.testing.assert_allclose(float(t.objective(ts["x"])), float(j.objective(jnp.asarray(x))), rtol=1e-5)
    tx, tz = t.run(2)
    assert tx.shape == shape and tz.shape == (2,) + shape
    warm = {k: np.array(v) for k, v in js_.items()}
    back = t.run_fixed(2, state=shard_state_from_numpy(warm, t.mesh))
    _assert_state_close(back, j.run_fixed(N_IT + 2), ("x", "z"))


def test_spatial2d_rank2_objective_matches_jax(rng):
    """The objective through the per-rank composition of the separable band
    passes (a rank-2 PSF on megar2d), against the JAX solver's."""
    shape = (128, 256)  # the reference's megar2d gates: h_loc % 32, w_loc % 128
    filt, y, _ = _dist_problem(rng, shape, "rank2")
    j = JaxSpatial2D(shape, filt, jnp.asarray(y), LAM, mesh=_jmesh2(), use_pallas="interpret")
    t = Spatial2DTVDeconv2D(shape, filt, y, LAM, mesh=_mesh2(), use_pallas="interpret")
    assert t._sp_engine == "megar2d" and t.rank == 2
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    np.testing.assert_allclose(float(t.objective(x)), float(j.objective(jnp.asarray(x))), rtol=1e-5)


# -- BatchedDistributedTVDeconv2D ----------------------------------------------------------


def test_batched_matches_jax(rng):
    shape, B = (64, 48), 4
    h = _psf("gauss5x3")
    y = np.abs(rng.standard_normal((B,) + shape)).astype(np.float32)
    jm = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    j = JaxBatched(shape, h, jnp.asarray(y), LAM, mesh=jm)
    t = BatchedDistributedTVDeconv2D(shape, h, y, LAM, mesh=make_mesh((2, 2), ("dp", "sp"), devices=["cpu"] * 4))
    assert t.tau == pytest.approx(j.tau, rel=1e-12)
    assert len(t._inners) == 2 and t._inners[0]._sp_engine == ""
    ts, js_ = t.run_fixed(N_IT), j.run_fixed(N_IT)
    out = state_to_numpy(ts)
    assert out["x"].shape == (B,) + shape and out["z"].shape == (B, 2) + shape
    _assert_state_close(ts, js_, ("x", "z"))
    np.testing.assert_allclose(ts["history"][:N_IT].numpy(), np.asarray(js_["history"])[:N_IT], rtol=1e-4)
    # a JAX batch state carried across into the bricks
    warm = {k: np.array(v) for k, v in js_.items()}
    back = t.run_fixed(2, state=shard_state_from_numpy(warm, t.mesh))
    _assert_state_close(back, j.run_fixed(N_IT + 2), ("x", "z"))
    tx, tz = t.run(2)
    jx, jz = j.run(2)
    _close(tx, np.asarray(jx))
    _close(tz, np.asarray(jz))


def test_batched_refusals():
    y = np.zeros((3, 64, 48), np.float32)
    m = make_mesh((2, 2), ("dp", "sp"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="batch 3 must divide"):
        BatchedDistributedTVDeconv2D((64, 48), _psf("gauss7"), y, LAM, mesh=m)
    with pytest.raises(ValueError, match="2-D"):
        BatchedDistributedTVDeconv2D((64, 48), _psf("gauss7"), y, LAM, mesh=_mesh(4))
    with pytest.raises(ValueError, match=r"\(batch, H, W\)"):
        BatchedDistributedTVDeconv2D((64, 48), _psf("gauss7"), y[0], LAM, mesh=m)
