"""The row-sharded slice of the port against the JAX package, on the CPU.

* The halo exchange (``parallel/spatial.py``) against slices of the global
  array, zeros beyond the image.
* K14-K16's plain versions (mega2, megar and sweep on a row shard) against
  the JAX shard kernels in interpret mode, called outside ``shard_map`` on
  the first, a middle and the last shard with halos cut from the global
  arrays: rtol 3e-5 / atol 3e-6 (the reference's own, for one launch); the
  core's partial sums within rtol 1e-4 (f32 sums in another order).
* P plain shard steps, joined, against the port's single-device plain
  engine on the whole image: within rtol 1e-6 (the same arithmetic).
* ``DistributedTVDeconv2D`` (port on P CPU devices, ``"interpret"``)
  against the JAX solver (``use_pallas="interpret"`` on P of the
  conftest's virtual devices) after 6 iterations: x, z0, z1 within rtol
  1e-4 / atol 1e-5 max|x| (A^H y by K1's plain version against the
  reference's FFT, and its bf16x3 MXU Grams); the metric history, the
  engine pick, the state carried across, the objective and the refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pycsou_tpu.kernels.tv import tv_pds_mega2_shard_step as jax_mega2_shard
from pycsou_tpu.kernels.tv import tv_pds_sweep_shard_step as jax_sweep_shard
from pycsou_tpu.kernels.tvr import tv_pds_megar_shard_step as jax_megar_shard
from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D as JaxDistributed
from pycsou_tpu_torch.kernels.tv import (
    tv_pds_mega2_shard_step,
    tv_pds_mega2_step_plain,
    tv_pds_sweep_shard_step,
    tv_pds_sweep_step_stats_plain,
)
from pycsou_tpu_torch.kernels.tvr import tv_pds_megar_shard_step, tv_pds_megar_step_plain
from pycsou_tpu_torch.ops import Convolve2D
from pycsou_tpu_torch.parallel import (
    DistributedTVDeconv2D,
    halo_extend,
    halo_from_next,
    halo_from_prev,
    halos,
    make_mesh,
)
from pycsou_tpu_torch.utils.convert import shard_state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


H, W = 256, 384
LAM = 0.05
KW = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.05, nonneg=True, iso=True)


def _gauss(K, s=2.0):
    ax = np.arange(K) - K // 2
    g = np.exp(-(ax**2) / (2 * s * s))
    return g / g.sum()


def _psf(kind):
    if kind == "gauss7":
        return np.outer(_gauss(7), _gauss(7)).astype(np.float32)
    if kind == "rank2":
        h = np.outer(_gauss(7), _gauss(7)) + 0.4 * np.outer(_gauss(7, 0.8), _gauss(7, 4.0))
        return (h / h.sum()).astype(np.float32)
    if kind == "gauss17":
        return np.outer(_gauss(17, 3.0), _gauss(17, 3.0)).astype(np.float32)
    h = np.random.default_rng(0).random((7, 7))  # rank 7: no fused engine
    return (h / h.sum()).astype(np.float32)


def _jax_mesh(P):
    return JaxMesh(np.asarray(jax.devices()[:P]), ("sp",))


def _mesh(P):
    return make_mesh((P,), devices=["cpu"] * P)


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


def _halos(a, i, P, R):
    """(top, bottom) (R, W) halo blocks of shard i of the global array a."""
    h = a.shape[0] // P
    zero = np.zeros((R,) + a.shape[1:], a.dtype)
    top = a[i * h - R : i * h] if i > 0 else zero
    bot = a[(i + 1) * h : (i + 1) * h + R] if i < P - 1 else zero
    return top, bot


# -- the halo exchange -------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4, 8])
def test_halo_exchange_matches_global_slices(rng, P):
    a = rng.standard_normal((64, 5)).astype(np.float32)
    h = 64 // P
    blocks = [_t(a[i * h : (i + 1) * h]) for i in range(P)]
    for R in (1, 3, h):
        prev, nxt, ext = halo_from_prev(blocks, R), halo_from_next(blocks, R), halo_extend(blocks, R)
        for i in range(P):
            top, bot = _halos(a, i, P, R)
            assert np.array_equal(prev[i].numpy(), top) and np.array_equal(nxt[i].numpy(), bot)
            assert np.array_equal(ext[i].numpy(), np.concatenate([top, a[i * h : (i + 1) * h], bot]))
    assert halo_from_prev(blocks, 0)[1].shape == (0, 5)
    with pytest.raises(ValueError, match="halo rows"):
        halo_from_next(blocks, h + 1)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_halos_interleave_each_shards_neighbours(rng, P):
    """``halos`` gives each shard (a_top, a_bot, b_top, b_bot) of every
    array; the zero blocks beyond the image's edges are made once and
    shared."""
    a, b = (rng.standard_normal((32, 6)).astype(np.float32) for _ in range(2))
    h, R = 32 // P, 3
    blocks = [[_t(v[i * h : (i + 1) * h]) for i in range(P)] for v in (a, b)]
    got = halos(blocks, R)
    assert len(got) == P
    for i, hl in enumerate(got):
        want = [*_halos(a, i, P, R), *_halos(b, i, P, R)]
        assert len(hl) == 4 and all(np.array_equal(g.numpy(), w) for g, w in zip(hl, want))
    again = halos(blocks, R)
    assert again[0][0] is got[0][0] and again[-1][1] is got[-1][1]


# -- K14-K16's plain versions against the JAX shard kernels -------------------


def _shard_case(rng, kernel, i, P=4):
    """(port output, JAX output) of one shard kernel on shard i."""
    x, z0, z1, a = _state(rng)
    h = H // P
    core = slice(i * h, (i + 1) * h)
    if kernel == "sweep":
        R = 8
        hal = [b for arr in (x, a, z0, z1) for b in _halos(arr, i, P, R)]
        off = i * h - R
        want = jax_sweep_shard(_j(x[core]), _j(a[core]), _j(z0[core]), _j(z1[core]), tuple(_j(b) for b in hal),
                               jnp.asarray([off], jnp.int32), H_global=H, R=R, interpret=True, **KW)
        got = tv_pds_sweep_shard_step(_t(x[core]), _t(a[core]), _t(z0[core]), _t(z1[core]),
                                      tuple(_t(b) for b in hal), off, H_global=H, **KW)
        return got, want
    filt = _psf("gauss7" if kernel == "mega2" else "rank2")
    js = JaxDistributed((H, W), filt, _j(a), LAM, mesh=_jax_mesh(P), use_pallas="interpret")
    R = js._sp_r
    hal = [b for arr in (x, z0, z1) for b in _halos(arr, i, P, R)]
    top, bot = _halos(a, i, P, R)
    ext = np.concatenate([top, a[core], bot])
    off = i * h - R
    joff = jnp.asarray([off], jnp.int32)
    jhal = tuple(_j(b) for b in hal)
    conv = Convolve2D((H, W), filt, device="cpu")
    args = (_t(x[core]), _t(z0[core]), _t(z1[core]), _t(ext), tuple(_t(b) for b in hal))
    if kernel == "mega2":
        want = jax_mega2_shard(_j(x[core]), _j(z0[core]), _j(z1[core]), _j(ext), jhal, js._corr_local(_j(x[core])),
                               js._mega_B, js._mega_C, js._mega_F, joff, H_global=H, mega_r=R, interpret=True, **KW)
        got = tv_pds_mega2_shard_step(*args, conv.gram, off, H_global=H, **KW)
    else:
        want = jax_megar_shard(_j(x[core]), _j(z0[core]), _j(z1[core]), _j(ext), jhal, js._megar_Bf,
                               js._megar_Cf, js._megar_Ba, js._megar_Ca, joff, H_global=H, mega_r=R,
                               interpret=True, **KW)
        got = tv_pds_megar_shard_step(*args, conv.fwd, conv.fwd.adjoint(2.0), off, H_global=H, **KW)
    return got, want


@pytest.mark.parametrize("i", [0, 1, 3], ids=["first", "middle", "last"])
@pytest.mark.parametrize("kernel", ["sweep", "mega2", "megar"])
def test_shard_plain_matches_pallas(rng, kernel, i):
    """K16 (sweep), K14 (mega2), K15 (megar): the wrapper's CPU route
    against the Pallas shard kernel in interpret mode."""
    got, want = _shard_case(rng, kernel, i)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 3e-5, 3e-6)
    _close(got[3], np.asarray(want[3])[0, :6], 1e-4, 1e-6)


@pytest.mark.parametrize("kernel", ["sweep", "mega2", "megar"])
def test_shard_steps_join_to_the_single_device_engine(rng, kernel):
    """P shard steps (halos from the exchange), joined, equal the port's
    single-device plain engine on the whole image; their partial sums add
    up to its."""
    P, kw = 4, dict(KW, iso=kernel != "megar", nonneg=kernel != "sweep")
    x, z0, z1, a = (_t(v) for v in _state(rng))
    conv = Convolve2D((H, W), _psf("gauss7" if kernel != "megar" else "rank2"), device="cpu")
    gram, adj2 = conv.gram, conv.fwd.adjoint(2.0)
    R = {"sweep": 1, "mega2": 16, "megar": 32}[kernel]
    h = H // P
    xs, z0s, z1s, as_ = ([v[k * h : (k + 1) * h].contiguous() for k in range(P)] for v in (x, z0, z1, a))
    ext = halo_extend(as_, R)

    outs = []
    if kernel == "sweep":
        want = tv_pds_sweep_step_stats_plain(x, z0, z1, a, **kw)
        for k, hl in enumerate(halos((xs, as_, z0s, z1s), R)):
            outs.append(tv_pds_sweep_shard_step(xs[k], as_[k], z0s[k], z1s[k], hl, k * h - R, H_global=H, **kw))
    elif kernel == "mega2":
        want = tv_pds_mega2_step_plain(x, z0, z1, a, gram, **kw)
        for k, hl in enumerate(halos((xs, z0s, z1s), R)):
            outs.append(tv_pds_mega2_shard_step(xs[k], z0s[k], z1s[k], ext[k], hl, gram, k * h - R, H_global=H, **kw))
    else:
        want = tv_pds_megar_step_plain(x, z0, z1, a, conv.fwd, adj2, **kw)
        for k, hl in enumerate(halos((xs, z0s, z1s), R)):
            outs.append(tv_pds_megar_shard_step(xs[k], z0s[k], z1s[k], ext[k], hl, conv.fwd, adj2, k * h - R,
                                                H_global=H, **kw))
    for j in range(3):
        _close(torch.cat([o[j] for o in outs]), want[j], 1e-6, 1e-7)
    _close(sum(o[3] for o in outs), want[3], 1e-5, 0)


def test_shard_kernels_check_their_halos(rng):
    x, z0, z1, a = (_t(v[:64]) for v in _state(rng))
    hal = tuple(torch.zeros(4, W) for _ in range(8))
    with pytest.raises(ValueError, match="8 halo blocks"):
        tv_pds_sweep_shard_step(x, a, z0, z1, hal[:6], -4, H_global=H, **KW)
    with pytest.raises(ValueError, match="outside an image"):
        tv_pds_sweep_shard_step(x, a, z0, z1, hal, H - 32, H_global=H, **KW)
    gram = Convolve2D((H, W), _psf("gauss7"), device="cpu").gram
    ext = torch.zeros(72, W)
    with pytest.raises(ValueError, match="reads 9 rows"):
        tv_pds_mega2_shard_step(x, z0, z1, ext, hal[:6], gram, -4, H_global=H, **KW)


# -- the solver against the JAX solver ----------------------------------------


def _problem(rng, kind):
    y = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    if kind == "sweepsp":
        mask = (rng.random((H, W)) < 0.7).astype(np.float32)
        return None, mask * y, mask
    return _psf("gauss7" if kind.startswith("megasp") else "rank2"), y, None


def _pair(rng, kind, P, **kw):
    filt, y, mask = _problem(rng, kind)
    iso = kind != "megasp-aniso"
    j = JaxDistributed((H, W), filt, _j(y), LAM, mesh=_jax_mesh(P), use_pallas="interpret",
                       mask=None if mask is None else _j(mask), isotropic=iso, **kw)
    t = DistributedTVDeconv2D((H, W), filt, y, LAM, mesh=_mesh(P), use_pallas="interpret", mask=mask,
                              isotropic=iso, **kw)
    return j, t


def _assert_state_close(tstate, jstate):
    scale = max(1.0, float(np.abs(np.asarray(jstate["x"])).max()))
    out = state_to_numpy(tstate)
    for k in ("x", "z0", "z1"):
        _close(out[k], np.asarray(jstate[k]), 1e-4, 1e-5 * scale)


@pytest.mark.parametrize("kind,P", [("megasp", 2), ("megasp", 4), ("megarsp", 2), ("megarsp", 4),
                                    ("sweepsp", 4), ("megasp-aniso", 2)])
def test_distributed_matches_jax(rng, kind, P):
    j, t = _pair(rng, kind, P)
    engine = kind.split("-")[0]
    assert j._sp_engine == t._sp_engine == engine
    assert t.tau == pytest.approx(j.tau, rel=1e-12) and t.sigma == pytest.approx(j.sigma, rel=1e-12)
    n0 = [f.launches for f in (tv_pds_mega2_shard_step, tv_pds_megar_shard_step, tv_pds_sweep_shard_step)]
    ts, js = t.run_fixed(6), j.run_fixed(6)
    # CPU tensors: the plain versions, no launch
    assert [f.launches for f in (tv_pds_mega2_shard_step, tv_pds_megar_shard_step, tv_pds_sweep_shard_step)] == n0
    assert ts["it"] == int(js["it"]) == 6 and len(ts["x"]) == P
    assert all(s.shape == (H // P, W) for s in ts["x"])
    _assert_state_close(ts, js)
    _close(ts["history"][:6].numpy(), np.asarray(js["history"])[:6], 1e-4, 0)


def test_solve_metric_and_diagnostics_match_jax(rng):
    """solve() driven by the summed partial sums: the metric history and the
    per-variable diagnostics against the JAX solver's."""
    kw = dict(max_iter=12, min_iter=3, accuracy_threshold=0.0)
    j, t = _pair(rng, "megasp", 2, **kw)
    ti, ji = t.solve(), j.solve()
    assert ti.n_iter == ji.n_iter == 12
    _close(ti.history, ji.history, 1e-3, 0)
    assert set(ti.diagnostics) == set(ji.diagnostics) == {"x", "z0", "z1"}
    for k in ("z0", "z1"):
        _close(ti.diagnostics[k][1:], ji.diagnostics[k][1:], 1e-3, 0)
    assert ti["x"].shape == (H, W)  # joined on the first mesh device
    _close(ti["x"], np.asarray(ji["x"]), 1e-4, 2e-5)


def test_run_and_objective_match_jax(rng):
    for kind in ("megasp", "sweepsp"):
        j, t = _pair(rng, kind, 4)
        tx, tz = t.run(4)
        jx, jz = j.run(4)
        assert tx.shape == (H, W) and tz.shape == (2, H, W)
        _close(tx, np.asarray(jx), 1e-4, 1e-5)
        _close(tz, np.asarray(jz), 1e-4, 1e-5)
        xs = t.initial_state()["x"]
        assert len(xs) == 4 and len(t.z0) == 4 and t.z0[0].shape == (2, H // 4, W) and t.x0[0].shape == (H // 4, W)
        _close(t.objective(tx), j.objective(_j(tx.numpy())), 1e-5, 0)


# -- the engine pick -------------------------------------------------------------

# (shape, P, PSF or "mask"): the port's engine, and the reference's where it
# differs (the reference's TPU tile gates: W % 128, W >= 384, a row tile of
# 8, 16 or 32 dividing h_loc; the port's column reach <= 15 of rank1_gate)
_PICKS = [
    ((256, 384), 4, "gauss7", "megasp", None),
    ((128, 384), 8, "gauss7", "megasp", None),
    ((256, 384), 4, "rank2", "megarsp", None),
    ((256, 384), 8, "rank2", "megarsp", None),
    ((256, 384), 4, "gauss17", "megarsp", None),
    ((256, 384), 4, "mask", "sweepsp", None),
    ((96, 384), 4, "mask", "sweepsp", None),
    ((256, 200), 4, "gauss7", "megasp", "sweepsp"),
    ((100, 384), 4, "mask", "sweepsp", ""),
]


@pytest.mark.parametrize("shape,P,psf,port,ref", _PICKS)
def test_engine_pick_matches_reference(shape, P, psf, port, ref):
    """The port's pick against the JAX solver's ``_sp_engine`` with
    ``use_pallas="interpret"``: equal where only the mathematical gates
    decide, the documented difference where the reference's TPU tile gates
    do."""
    y = np.zeros(shape, np.float32)
    mask = np.ones(shape, np.float32) if psf == "mask" else None
    filt = None if psf == "mask" else _psf(psf)
    j = JaxDistributed(shape, filt, _j(y), LAM, mesh=_jax_mesh(P), use_pallas="interpret",
                       mask=None if mask is None else _j(mask))
    t = DistributedTVDeconv2D(shape, filt, y, LAM, mesh=_mesh(P), use_pallas="interpret", mask=mask)
    assert t._sp_engine == port
    assert j._sp_engine == (port if ref is None else ref)


# -- the state carried across ------------------------------------------------------


def test_jax_state_continues_in_the_port(rng):
    """A JAX solve continued in the port for 6 more iterations matches the
    JAX solve run for 12; the port's state goes back to the JAX layout."""
    j, t = _pair(rng, "megasp", 4)
    warm = {k: np.array(v) for k, v in j.run_fixed(6).items()}
    ts = shard_state_from_numpy(warm, t.mesh)
    assert len(ts["x"]) == 4 and ts["it"] == 6 and ts["_stats"].shape == (6,)
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
    """The reference's errors, and the engine each former refusal now picks,
    as the JAX solver does: sweepsp over the sharded Gram for a PSF or a
    shard that no fused engine takes, the chain for ``use_pallas=False``
    and ``"auto"`` on CPU devices."""
    y = np.zeros((H, W), np.float32)

    def engines(psf, P, use_pallas):
        t = DistributedTVDeconv2D((H, W), _psf(psf), y, LAM, mesh=_mesh(P), use_pallas=use_pallas)
        if P > 8:  # the conftest's JAX mesh has 8 devices
            return t._sp_engine
        j = JaxDistributed((H, W), _psf(psf), _j(y), LAM, mesh=_jax_mesh(P), use_pallas=use_pallas)
        return t._sp_engine, j._sp_engine

    assert engines("full", 4, "interpret") == ("sweepsp", "sweepsp")
    assert engines("gauss7", 4, False) == ("", "")
    assert engines("gauss7", 4, "auto") == ("", "")  # "auto" on CPU devices: the chain
    assert engines("gauss7", 32, "interpret") == "sweepsp"  # 8-row shards: too short for megasp and megarsp
    with pytest.raises(ValueError, match="1-D mesh"):
        DistributedTVDeconv2D((H, W), _psf("gauss7"), y, LAM, use_pallas="interpret",
                              mesh=make_mesh((2, 2), ("dp", "sp"), devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="divide"):
        DistributedTVDeconv2D((H, W), _psf("gauss7"), y, LAM, mesh=_mesh(3), use_pallas="interpret")
    with pytest.raises(ValueError, match="CPU meshes"):
        DistributedTVDeconv2D((H, W), _psf("gauss7"), y, LAM, mesh=_mesh(4), use_pallas=True)
    with pytest.raises(ValueError, match="pass filt=None"):
        DistributedTVDeconv2D((H, W), _psf("gauss7"), y, LAM, mesh=_mesh(4), use_pallas="interpret", mask=y)


def test_make_mesh(monkeypatch):
    m = make_mesh((2, 3), ("dp", "sp"), devices=["cpu"] * 6)
    assert m.shape == (2, 3) and m.size == 6 and len(m.devices) == 6
    assert make_mesh(devices=["cpu"] * 4).shape == (4,)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((8,), devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
