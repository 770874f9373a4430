"""The iterative solvers' checkpoints, objective and iterates, on the CPU.

* ``remat=True`` changes no iterate (bit for bit) and no solver's step
  needs or builds an autograd graph (each run under ``torch.inference_mode``
  equals the run outside it, bit for bit, and no output requires grad).
* ``track_objective``'s history, ``iterates`` and ``iterate`` against the
  JAX package on the same numpy inputs: rtol 1e-4 (atol 1e-5 max|x| for
  iterates).
* ``utils/checkpoint.py``: round trips of every kind of entry (tuples of
  shards, lists of dicts, Python ints), the histories grown for a larger
  ``max_iter``, each tensor on its template tensor's device, a torn newest
  file skipped with a warning, a reconfigured solver refused with
  ``RuntimeError``, staging files never listed.
* ``solve(checkpoint_dir=...)``: a resumed solve equals the uninterrupted
  one bit for bit (PDS, TVDeconvolution, APGD, PMYULA,
  DistributedTVDeconv2D, ConsensusADMM), the ``step_{it}`` names are the
  JAX solve's, a SIGKILL'd worker resumes in a fresh process, and a JAX
  Orbax checkpoint read with the JAX package's ``load_state`` and carried
  across by ``utils/convert.py`` is finished by the port as the JAX solve
  finishes it (rtol 1e-4 / atol 1e-5 max|x|).
* ``utils/profiling.py``: a trace file with the annotated span, and
  ``device_time``.
"""
import json
import os
import signal
import subprocess
import sys
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.ops as jops
import pycsou_tpu.ops.conv as jconv
import pycsou_tpu.ops.diff as jdiff
import pycsou_tpu.opt as jopt
from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D as JaxDistributed
from pycsou_tpu.utils import checkpoint as jckpt
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.core.solver import IterativeSolver
from pycsou_tpu_torch.opt.admm import ConsensusADMM, stack_operators
from pycsou_tpu_torch.parallel import BatchedDistributedTVDeconv2D, DistributedTVDeconv2D, Spatial2DTVDeconv2D
from pycsou_tpu_torch.parallel import make_mesh
from pycsou_tpu_torch.utils import checkpoint, profiling
from pycsou_tpu_torch.utils.convert import shard_state_from_numpy, state_from_numpy, state_to_numpy
from pycsou_tpu_torch.utils.device import set_default_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


S = (32, 48)
LAM = 0.05


def _gauss(k=5, s=1.2):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _tv_data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal(S)).astype(np.float32)
    y = np.asarray(jconv.Convolve2D(S, jnp.asarray(_gauss())).apply(jnp.asarray(x)))
    return (y + 0.01 * rng.standard_normal(S)).astype(np.float32)


def _pds(pkg, y, **kw):
    """The README's PDS expression in ``pkg`` (``"jax"`` or ``"torch"``)."""
    if pkg == "jax":
        return jopt.PDS(S, F=jfunc.SquaredL2Loss(S, data=jnp.asarray(y)) * jconv.Convolve2D(S, jnp.asarray(_gauss())),
                        G=jfunc.NonNegativeOrthant(S), H=LAM * jpen.L21Norm((2,) + S, axis=0),
                        K=jdiff.Gradient(S), **kw)
    return topt.PDS(S, F=tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, _gauss()),
                    G=tfunc.NonNegativeOrthant(S), H=LAM * tfunc.L21Norm((2,) + S, axis=0), K=tops.Gradient(S),
                    **kw)


def _lasso_data(seed=1, m=24, n=16):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    return A, (A @ rng.standard_normal(n)).astype(np.float32)


def _apgd(pkg, A, y, **kw):
    beta = 2.0 * float(np.linalg.norm(A.astype(np.float64), 2)) ** 2
    if pkg == "jax":
        F = jfunc.SquaredL2Loss((A.shape[0],), data=jnp.asarray(y)) * jops.DenseOperator(jnp.asarray(A))
        return jopt.APGD((A.shape[1],), F=F, G=0.1 * jfunc.L1Norm((A.shape[1],)), beta=beta, **kw)
    F = tfunc.SquaredL2Loss((A.shape[0],), data=y) * tops.DenseOperator(A)
    return topt.APGD((A.shape[1],), F=F, G=0.1 * tfunc.L1Norm((A.shape[1],)), beta=beta, **kw)


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _equal_states(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k], equal_nan=True), k


# -- remat and autograd -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["PDS", "APGD"])
def test_remat_changes_no_iterate(kind):
    """``remat=True`` (the reference's ``jax.checkpoint``) gives the same
    iterates bit for bit; the JAX solver with remat agrees within rtol."""
    if kind == "PDS":
        y = _tv_data()
        mk = lambda pkg, **kw: _pds(pkg, y, max_iter=50, **kw)  # noqa: E731
    else:
        A, b = _lasso_data()
        mk = lambda pkg, **kw: _apgd(pkg, A, b, max_iter=50, **kw)  # noqa: E731
    plain, remat = mk("torch").run_fixed(12), mk("torch", remat=True).run_fixed(12)
    assert mk("torch", remat=True).remat is True
    _equal_states(plain, remat)
    js = mk("jax", remat=True).run_fixed(12)
    _close(remat["x"], js["x"])


def _solvers():
    """A small instance of each solver of the port, on the CPU."""
    y = _tv_data()
    A, b = _lasso_data()
    mask = (np.random.default_rng(2).random(S) < 0.7).astype(np.float32)
    mesh = make_mesh((2,), devices=["cpu"] * 2)
    mats = [np.random.default_rng(k).standard_normal((10, 12)).astype(np.float32) for k in range(4)]
    return {
        "PDS fused": lambda: _pds("torch", y, max_iter=50),
        "PDS generic": lambda: _pds("torch", y, max_iter=50, fuse=False),
        "APGD": lambda: _apgd("torch", A, b, max_iter=50),
        "TVDeconvolution mask": lambda: topt.TVDeconvolution(S, mask * y, LAM, mask=mask, max_iter=50),
        "LassoDeconvolution": lambda: topt.APGD(
            S, F=tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, _gauss()), G=0.01 * tfunc.L1Norm(S),
            max_iter=50),
        "PMYULA": lambda: topt.PMYULA(S, F=tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, _gauss()),
                                      G=0.01 * tfunc.L1Norm(S), seed=3, max_iter=50, pvalues=(0.5,)),
        "Distributed chain": lambda: DistributedTVDeconv2D(S, _gauss(), y, LAM, mesh=mesh, use_pallas=False),
        "Distributed megasp": lambda: DistributedTVDeconv2D(S, _gauss(), y, LAM, mesh=mesh, use_pallas="interpret"),
        "Spatial2D chain": lambda: Spatial2DTVDeconv2D(
            S, None, mask * y, LAM, mask=mask, mesh=make_mesh((2, 2), ("sp0", "sp1"), devices=["cpu"] * 4)),
        "Batched": lambda: BatchedDistributedTVDeconv2D(
            S, _gauss(), np.stack([y, y[::-1]]), LAM, mesh=make_mesh((2, 2), ("dp", "sp"), devices=["cpu"] * 4)),
        "ConsensusADMM": lambda: ConsensusADMM(
            (12,), ops=stack_operators([tops.DenseOperator(M) for M in mats]),
            data=np.stack([M @ np.ones(12, np.float32) for M in mats]), rho=1.0,
            mesh=make_mesh((2,), ("dp",), devices=["cpu"] * 2)),
    }


def _leaves(v):
    if isinstance(v, dict):
        return [t for e in v.values() for t in _leaves(e)]
    if isinstance(v, (tuple, list)):
        return [t for e in v for t in _leaves(e)]
    return [v] if isinstance(v, torch.Tensor) else []


@pytest.mark.parametrize("kind", list(_solvers()))
def test_steps_build_no_autograd_graph(kind):
    """What ``remat`` would rematerialise does not exist: every step runs
    under ``torch.inference_mode`` with the same result bit for bit, and
    outside it no output requires grad."""
    make = _solvers()[kind]
    solver = make()
    with torch.inference_mode():
        inside = solver.run_fixed(4)
    outside = make().run_fixed(4)
    _equal_states(inside, outside)
    assert all(not t.requires_grad and t.grad_fn is None for t in _leaves(outside))


# -- track_objective, iterates, iterate -------------------------------------------------


@pytest.mark.parametrize("kind", ["PDS", "TVDeconvolution"])
def test_objective_history_matches_jax(kind):
    y = _tv_data()
    kw = dict(max_iter=20, min_iter=20, accuracy_threshold=0.0)
    if kind == "PDS":
        j, t = _pds("jax", y, **kw), _pds("torch", y, **kw)
    else:
        j = jopt.TVDeconvolution(S, jnp.asarray(y), LAM, filt=jnp.asarray(_gauss()), use_pallas=False, **kw)
        t = topt.TVDeconvolution(S, y, LAM, filt=_gauss(), **kw)
    j.track_objective = t.track_objective = True
    ti, ji = t.solve(), j.solve()
    assert ti.n_iter == ji.n_iter == 20
    assert ti.objective_history.shape == (20,) and np.isfinite(ti.objective_history).all()
    np.testing.assert_allclose(ti.objective_history, ji.objective_history, rtol=1e-4)
    # the last entry is the objective at the final iterate
    np.testing.assert_allclose(ti.objective_history[-1], float(t.objective(ti["x"])), rtol=1e-6)
    assert topt.TVDeconvolution(S, y, LAM, filt=_gauss()).solve().objective_history is None


@pytest.mark.parametrize("kind", ["APGD", "TVDeconvolution"])
def test_iterates_match_jax(kind):
    """``iterates(n, stride)`` yields every ``stride`` iterations (the
    reference's ``tests/test_solvers.py:133``), each equal to ``run_fixed``
    of as many iterations, and against the JAX solver's yields."""
    if kind == "APGD":
        A, b = _lasso_data()
        j, t = _apgd("jax", A, b, max_iter=100), _apgd("torch", A, b, max_iter=100)
    else:
        y = _tv_data()
        j = jopt.TVDeconvolution(S, jnp.asarray(y), LAM, filt=jnp.asarray(_gauss()), use_pallas=False)
        t = topt.TVDeconvolution(S, y, LAM, filt=_gauss())
    touts, jouts = list(t.iterates(30, stride=10)), list(j.iterates(30, stride=10))
    assert len(touts) == len(jouts) == 3
    for k, (a, b) in enumerate(zip(touts, jouts)):
        assert "history" not in a
        _close(a["x"], b["x"])
        assert torch.equal(a["x"], t.postprocess(t.run_fixed(10 * (k + 1)))["x"])


def test_iterates_round_the_stride_up_to_whole_steps():
    """With two iterations a step (mega3, sweepm2) a stride of 3 is 4, so
    every yield advances (the reference's ``tests/test_advice_r3.py:117``)."""

    class Counting(IterativeSolver):
        iters_per_step = 2

        def initial_state(self):
            return {"x": torch.zeros(4)}

        def step(self, state):
            return {"x": state["x"] + 1.0}

    s = Counting(max_iter=100, tol=0.0)
    vals = [float(out["x"][0]) for out in s.iterates(8, stride=3)]
    assert vals == [2.0, 4.0]
    assert [float(out["x"][0]) for out in s.iterates(4, stride=1)] == [1.0, 2.0]


def test_iterate_is_solve():
    A, b = _lasso_data()
    kw = dict(max_iter=40, min_iter=40, accuracy_threshold=0.0)
    a, s = _apgd("torch", A, b, **kw).iterate(), _apgd("torch", A, b, **kw).solve()
    assert a.n_iter == s.n_iter == 40 and torch.equal(a["x"], s["x"])


# -- utils/checkpoint.py -------------------------------------------------------------


def _nested_state():
    return {"x": (torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)), "it": 7,
            "p2": [{"count": torch.zeros((), dtype=torch.int32), "q": torch.full((5, 2), 0.5)}],
            "n": torch.tensor(3, dtype=torch.int32), "history": torch.full((8,), float("nan"))}


def test_save_load_roundtrip_to_template_devices(tmp_path):
    state = _nested_state()
    path = str(tmp_path / "ck" / "step_7")
    checkpoint.save_state(path, state)
    assert os.listdir(tmp_path / "ck") == ["step_7"]  # the staging file renamed away
    raw = checkpoint.load_state(path)
    assert raw["it"] == 7 and isinstance(raw["it"], int) and isinstance(raw["x"], tuple)
    _equal_states(raw, state)
    # each tensor goes to its template tensor's device (here "meta")
    template = {k: v for k, v in _nested_state().items()}
    template["x"] = (template["x"][0].to("meta"), template["x"][1])
    out = checkpoint.load_state(path, template=template)
    assert out["x"][0].device.type == "meta" and out["x"][1].device.type == "cpu"
    # a view is written as its own elements only
    big = torch.zeros(1000)
    checkpoint.save_state(str(tmp_path / "v" / "step_1"), {"x": big[:4]})
    assert os.path.getsize(tmp_path / "v" / "step_1") < 2000


def test_history_grows_for_a_larger_max_iter(tmp_path):
    state = _nested_state()
    checkpoint.save_state(str(tmp_path / "step_7"), state)
    bigger = _nested_state()
    bigger["history"] = torch.zeros(16)
    out = checkpoint.load_state(str(tmp_path / "step_7"), template=bigger)
    assert out["history"].shape == (16,) and torch.isnan(out["history"][8:]).all()
    smaller = _nested_state()
    smaller["history"] = torch.zeros(4)
    with pytest.raises(ValueError, match="history"):
        checkpoint.load_state(str(tmp_path / "step_7"), template=smaller)


def test_torn_newest_checkpoint_is_skipped_with_a_warning(tmp_path):
    state = _nested_state()
    checkpoint.save_state(str(tmp_path / "step_7"), state)
    (tmp_path / "step_9").write_bytes(b"PK\x03\x04 torn")  # a kill mid-write
    (tmp_path / "step_11.staging-123").write_bytes(b"")  # a save in flight: never listed
    assert [os.path.basename(p) for p in checkpoint.checkpoint_steps(str(tmp_path))] == ["step_9", "step_7"]
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("step_9")
    with pytest.warns(UserWarning, match="skipped 1 unreadable"):
        out = checkpoint.load_latest_state(str(tmp_path), template=_nested_state())
    assert out["it"] == 7


def test_reconfigured_solver_raises(tmp_path):
    checkpoint.save_state(str(tmp_path / "step_7"), _nested_state())
    for change in ({"x": (torch.zeros(2, 3),)}, {"x": (torch.zeros(2, 4), torch.zeros(2, 3))},
                   {"n": torch.tensor(3.0)}, {"extra": torch.zeros(1)}):
        with pytest.raises(RuntimeError, match="fit the solver"):
            checkpoint.load_latest_state(str(tmp_path), template={**_nested_state(), **change})
    assert checkpoint.load_latest_state(str(tmp_path / "none"), template=_nested_state()) is None


# -- solve(checkpoint_dir=...) -------------------------------------------------------


def _resumables():
    y = _tv_data()
    A, b = _lasso_data()
    mats = [np.random.default_rng(k).standard_normal((10, 12)).astype(np.float32) for k in range(4)]
    return {
        "PDS": lambda n: _pds("torch", y, max_iter=n, min_iter=n, accuracy_threshold=0.0),
        "TVDeconvolution": lambda n: topt.TVDeconvolution(S, y, LAM, filt=_gauss(), max_iter=n, min_iter=n,
                                                          accuracy_threshold=0.0),
        "APGD": lambda n: _apgd("torch", A, b, max_iter=n, min_iter=n, accuracy_threshold=0.0),
        "PMYULA": lambda n: topt.PMYULA(S, F=tfunc.SquaredL2Loss(S, data=y) * tops.Convolve2D(S, _gauss()),
                                        G=0.01 * tfunc.L1Norm(S), seed=3, pvalues=(0.5,),
                                        scalar_fns=(lambda x: torch.sum(x),), max_iter=n, min_iter=n,
                                        accuracy_threshold=0.0),
        "DistributedTVDeconv2D": lambda n: DistributedTVDeconv2D(
            S, _gauss(), y, LAM, mesh=make_mesh((4,), devices=["cpu"] * 4), use_pallas=False, max_iter=n,
            min_iter=n, accuracy_threshold=0.0),
        "ConsensusADMM": lambda n: ConsensusADMM(
            (12,), ops=stack_operators([tops.DenseOperator(M) for M in mats]),
            data=np.stack([M @ np.ones(12, np.float32) for M in mats]), rho=1.0, max_iter=n, min_iter=n,
            accuracy_threshold=0.0, mesh=make_mesh((2,), ("dp",), devices=["cpu"] * 2)),
    }


class _Fault(Exception):
    pass


@pytest.mark.parametrize("kind", list(_resumables()))
def test_resume_equals_uninterrupted(tmp_path, kind):
    """A solve that dies at iteration 50 (after its saves at 20 and 40,
    ``verbose=20``) resumed by a fresh solver ends on the state of one
    uninterrupted solve, bit for bit."""
    make = _resumables()[kind]
    d = str(tmp_path / "ck")
    dying = make(60)
    dying.verbose = 20
    step, calls = dying.step, []

    def faulty(state):
        calls.append(1)
        if len(calls) * dying.iters_per_step >= 50:
            raise _Fault
        return step(state)

    dying.step = faulty
    with pytest.raises(_Fault):
        dying.solve(checkpoint_dir=d)
    assert sorted(os.listdir(d)) == ["step_20", "step_40"]
    again = make(60)
    again.verbose = 20
    resumed = again.solve(checkpoint_dir=d)
    whole = make(60).solve()
    assert resumed.n_iter == whole.n_iter == 60
    assert sorted(os.listdir(d)) == ["step_20", "step_40", "step_60"]
    for k, v in whole.iterand.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(resumed[k], v), k
    np.testing.assert_array_equal(resumed.history, whole.history)


def test_resume_with_a_larger_max_iter(tmp_path):
    """A solve run to ``max_iter`` 30 and resumed with ``max_iter`` 60: its
    histories grow, and it ends on the 60-iteration solve's state."""
    make = _resumables()["TVDeconvolution"]
    d = str(tmp_path / "ck")
    assert make(30).solve(checkpoint_dir=d).n_iter == 30
    resumed, whole = make(60).solve(checkpoint_dir=d), make(60).solve()
    assert sorted(os.listdir(d)) == ["step_30", "step_60"]
    assert torch.equal(resumed["x"], whole["x"])
    np.testing.assert_array_equal(resumed.history, whole.history)
    np.testing.assert_array_equal(resumed.diagnostics["z0"], whole.diagnostics["z0"])


def test_step_names_are_the_references(tmp_path):
    """The saves of a solve to ``max_iter``: the reference's names (chunks of
    100 from the start, every ``checkpoint_every``-th, and the last)."""
    A, b = _lasso_data()
    kw = dict(max_iter=250, min_iter=250, accuracy_threshold=0.0)
    for every in (1, 2):
        jd, td = str(tmp_path / f"j{every}"), str(tmp_path / f"t{every}")
        _apgd("jax", A, b, **kw).solve(checkpoint_dir=jd, checkpoint_every=every)
        _apgd("torch", A, b, **kw).solve(checkpoint_dir=td, checkpoint_every=every)
        names = sorted(os.listdir(td))
        assert names == sorted(os.listdir(jd)) == (["step_100", "step_200", "step_250"] if every == 1
                                                   else ["step_200", "step_250"])


def test_sharded_state_resumes_onto_its_mesh(tmp_path):
    """A sharded state's shards load onto the template's devices (the
    per-shard ``meta`` template shows the placement, as CUDA shards go back
    to their cards) and keep their mesh layout."""
    s = DistributedTVDeconv2D(S, _gauss(), _tv_data(), LAM, mesh=make_mesh((4,), devices=["cpu"] * 4),
                              use_pallas=False)
    state = s.run_fixed(3)
    checkpoint.save_state(str(tmp_path / "step_3"), state)
    template = s._wrap_state(s.initial_state())
    template["x"] = tuple(t.to("meta") if i % 2 else t for i, t in enumerate(template["x"]))
    out = checkpoint.load_latest_state(str(tmp_path), template=template)
    assert [t.device.type for t in out["x"]] == ["cpu", "meta", "cpu", "meta"]
    assert len(out["z"]) == 4 and out["z"][0].shape == (2, 8, 48) and out["it"] == 3


def test_jax_orbax_checkpoint_is_finished_by_the_port(tmp_path):
    """A JAX generic PDS (its stacked ``z``) checkpointed by Orbax at
    iteration 20, read with the JAX package's ``load_state``, carried across
    into the port's fused layout (``z0``, ``z1``) and run 20 more: equal to
    the JAX run of 40.  Then a JAX chain state (stacked ``z``) of
    ``DistributedTVDeconv2D`` into the port's sweepsp shards."""
    y = _tv_data()
    jsolver = _pds("jax", y, max_iter=20, min_iter=20, accuracy_threshold=0.0, fuse=False)
    jsolver.solve(checkpoint_dir=str(tmp_path / "j"))
    path = jckpt.latest_checkpoint(str(tmp_path / "j"))
    assert path.endswith("step_20")
    restored = {k: np.asarray(v) if not isinstance(v, (dict, list)) else v
                for k, v in jckpt.load_state(path).items()}
    t = _pds("torch", y, max_iter=40)
    assert "z0" in t.initial_state()
    ts = t.run_fixed(20, state=state_from_numpy(restored, "cpu", like=t.initial_state()))
    want = _pds("jax", y, max_iter=40, fuse=False).run_fixed(40)
    assert ts["it"] == 40
    _close(ts["x"], want["x"])
    _close(torch.stack([ts["z0"], ts["z1"]]), want["z"])

    jd = JaxDistributed(S, _gauss(), jnp.asarray(y), LAM, mesh=_jax_mesh(2), use_pallas=False)
    td = DistributedTVDeconv2D(S, _gauss(), y, LAM, mesh=make_mesh((2,), devices=["cpu"] * 2),
                               use_pallas="interpret")
    warm = {k: np.array(v) for k, v in jd.run_fixed(5).items()}
    ts = td.run_fixed(5, state=shard_state_from_numpy(warm, td.mesh, like=td.initial_state()))
    want = jd.run_fixed(10)
    out = state_to_numpy(ts)
    _close(out["x"], want["x"])
    _close(np.stack([out["z0"], out["z1"]]), want["z"])


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("sp",))


_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from pycsou_tpu_torch.utils.device import set_default_device
set_default_device("cpu")
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
from pycsou_tpu_torch.opt import APGD

rng = np.random.default_rng(7)
A = rng.standard_normal((384, 768)).astype(np.float32)
y = (A @ (rng.random(768) < 0.05).astype(np.float32)).astype(np.float32)
beta = 2.0 * float(np.linalg.norm(A.astype(np.float64), 2)) ** 2
F = tfunc.SquaredL2Loss((384,), data=y) * tops.DenseOperator(A)
solver = APGD((768,), F=F, G=0.02 * tfunc.L1Norm((768,)), beta=beta, max_iter=4000, min_iter=4000,
              accuracy_threshold=0.0, verbose={chunk})
info = solver.solve(checkpoint_dir={ckpt!r})
np.save({out!r}, info.iterand["x"].numpy())
"""


def _worker(tmp_path, name, ckpt, out):
    script = tmp_path / name
    script.write_text(_WORKER.format(repo=REPO, chunk=50, ckpt=str(ckpt), out=str(out)))
    return [sys.executable, str(script)]


def test_sigkill_resume_matches_uninterrupted(tmp_path):
    """A worker killed by SIGKILL once a checkpoint exists, then a fresh
    process resuming from the newest loadable one: its final x equals an
    uninterrupted run's (the reference's ``tests/test_elastic.py``)."""
    out_ref, out = tmp_path / "ref.npy", tmp_path / "faulted.npy"
    ref = subprocess.Popen(_worker(tmp_path, "ref.py", tmp_path / "ck_ref", out_ref), stdout=subprocess.DEVNULL)
    ckpt = tmp_path / "ck"
    cmd = _worker(tmp_path, "worker.py", ckpt, out)
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not checkpoint.checkpoint_steps(str(ckpt)) and proc.poll() is None:
            time.sleep(0.01)
        assert proc.poll() is None, "the worker finished before the fault"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert not out.exists() and checkpoint.checkpoint_steps(str(ckpt))
    assert subprocess.run(cmd, stdout=subprocess.DEVNULL, timeout=300).returncode == 0
    assert ref.wait(timeout=300) == 0
    assert np.array_equal(np.load(out), np.load(out_ref))
    assert checkpoint.latest_checkpoint(str(ckpt)).endswith("step_4000")


# -- utils/profiling.py --------------------------------------------------------------


def test_trace_annotate_and_device_time(tmp_path):
    s = topt.TVDeconvolution(S, _tv_data(), LAM, filt=_gauss())
    with profiling.trace(str(tmp_path)), profiling.annotate("phase14"):
        s.run_fixed(2)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "phase14" in names
    t = profiling.device_time(s.run_fixed, 2, reps=3)
    assert 0.0 < t < 10.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert profiling.device_time(lambda: torch.ones(3), reps=2) >= 0.0
