"""The sharded solvers and operators of the port on a mesh that spans two
processes, on the CPU.

``tests/_mp_cases.py`` (torch, numpy and the port only) runs every case on
a mesh of four CPU positions three times, started once for the file and
alongside the JAX references: in one process (the one-process mesh), and
in two processes joined by ``distributed_init`` over gloo at
``tcp://127.0.0.1:<free port>``, two positions each, with the process
boundary along the rows, along the columns or between the ``dp`` rows as
each case's ranks say.  Each process writes its joined results to an
``.npz``.

* Both processes' joined results, and the one-process mesh's, are equal
  bit for bit: x, z, the metric history, the objective, ``solve()``'s
  iterand, history, ``converged_at`` and ``n_iter`` of every TV engine
  (megasp, megarsp, sweepsp, the band and FFT-Gram chains, megar2d on
  (2, 2) and (4, 1), the 2-D mask and rank-1 chains, the batch), of
  ``ConsensusADMM`` (its consensus sum folds in mesh order, so no
  tolerance), the dense, block-diagonal and pencil operators and a routed
  ``PDS.with_shardings``.
* The results after 6 iterations (operators: one apply) against the JAX
  package on its virtual CPU devices, within rtol 1e-4 / atol 1e-5
  max|x| (ADMM 3e-4 / 3e-5, the pencil pinv 1e-4 / 1e-5, as the one-process
  tests'): the JAX chain of the same problem (``use_pallas=False``) for the
  TV engines, whose iterates are the same mathematics.
* A two-process ``solve(checkpoint_dir=)`` saved at 20 and 40 iterations
  (written by the first process) and resumed to 60 equals the
  uninterrupted one-process solve, and one process resumes the
  two-process save to the same x.

The workers run under a timeout: on expiry they are killed and the test
fails.  It skips only where the host cannot open a localhost socket.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

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
from pycsou_tpu.ops import Convolve2D as JConvolve2D
from pycsou_tpu.ops import Gradient as JGradient
from pycsou_tpu.ops.basic import DenseOperator as JDense
from pycsou_tpu.ops.conv import CircularConvolve as JCircular
from pycsou_tpu.opt.admm import ConsensusADMM as JConsensusADMM
from pycsou_tpu.parallel import make_mesh as j_make_mesh
from pycsou_tpu.parallel.solvers import BatchedDistributedTVDeconv2D as JaxBatched
from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D as JaxDistributed
from pycsou_tpu.parallel.solvers import Spatial2DTVDeconv2D as JaxSpatial2D
from pycsou_tpu_torch.utils.device import set_default_device

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mp_cases as cases  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
_TIMEOUT = 150  # seconds for the three workers


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Runs:
    """The three workers, started at once; :meth:`get` waits for them (each
    with a timeout, the others killed on a failure) and loads their files."""

    def __init__(self, tmp):
        self.one, self.two = tmp / "one", tmp / "two"
        self.one.mkdir()
        self.two.mkdir()
        coord = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in [str(_ROOT), env.get("PYTHONPATH", "")] if p)
        env["OMP_NUM_THREADS"] = "1"
        worker = str(Path(cases.__file__).resolve())
        argv = [[str(self.one / "out.npz")], [str(self.two / "r0.npz"), coord, "0"],
                [str(self.two / "r1.npz"), coord, "1"]]
        self.procs = [subprocess.Popen([sys.executable, worker, *a], env=env, cwd=str(tmp), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True) for a in argv]
        self.results = None

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def get(self):
        if self.results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"the workers did not finish within {_TIMEOUT} s")
            finally:
                self.kill()
            joined = "\n".join(outs)
            if any(p.returncode != 0 for p in self.procs):
                if "Address family not supported" in joined or ("Permission denied" in joined and "socket" in joined):
                    pytest.skip(f"no localhost socket on this host:\n{joined[-500:]}")
                pytest.fail(f"a worker failed:\n{joined[-6000:]}")
            assert all("OK" in o for o in outs), joined
            self.results = [dict(np.load(f)) for f in (self.one / "out.npz", self.two / "r0.npz",
                                                       self.two / "r1.npz")]
        return self.results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        r = _Runs(tmp_path_factory.mktemp("mp"))
    except OSError as e:
        pytest.skip(f"no localhost socket on this host: {e}")
    yield r
    r.kill()


def _close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


# -- the JAX package --------------------------------------------------------------------------

_JAX = {}


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _jax_tv(case):
    """The JAX chain of the case's problem after 6 iterations (one run a
    problem, cached)."""
    kind, shape, pk, _, mshape, _ = cases.TV_CASES[case]
    key = (kind, shape, pk, mshape)
    if key not in _JAX:
        filt, y, mask = cases.tv_problem(shape, pk)
        m = None if mask is None else jnp.asarray(mask)
        if kind == "dist":
            j = JaxDistributed(shape, filt, jnp.asarray(y), cases.LAM, mesh=_jmesh(mshape, ("sp",)), use_pallas=False,
                               mask=m)
        elif kind == "2d":
            j = JaxSpatial2D(shape, filt, jnp.asarray(y), cases.LAM, mesh=_jmesh(mshape, ("sp0", "sp1")),
                             use_pallas=False, mask=m)
        else:
            yb = np.abs(np.random.default_rng(1).standard_normal((2,) + shape)).astype(np.float32)
            j = JaxBatched(shape, filt, jnp.asarray(yb), cases.LAM, mesh=_jmesh(mshape, ("dp", "sp")))
        st = j.run_fixed(cases.N_IT)
        z = st["z"] if "z" in st else jnp.stack([st["z0"], st["z1"]], axis=-3)
        _JAX[key] = (np.asarray(st["x"]), np.asarray(z))
    return _JAX[key]


@pytest.fixture(scope="module")
def jax_tv(runs):
    """Every TV case's JAX reference, made while the workers run."""
    return {case: _jax_tv(case) for case in cases.TV_CASES}


@pytest.mark.parametrize("case", list(cases.TV_CASES))
def test_tv_engines_across_processes_match_jax(runs, jax_tv, case):
    jx, jz = jax_tv[case]
    _, r0, _ = runs.get()
    scale = float(np.abs(jx).max())
    np.testing.assert_allclose(r0[f"{case}/x"], jx, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(r0[f"{case}/z"], jz, rtol=1e-4, atol=1e-5 * scale)


def test_admm_across_processes_matches_jax(runs):
    h_hats, ys = cases.admm_problem()
    j = JConsensusADMM((16, 16), h_hats, ys, g=jfunc.NonNegativeOrthant((16, 16)), rho=1.0,
                       mesh=j_make_mesh((4,), ("dp",)))
    st = j.run_fixed(cases.N_IT)
    _, r0, _ = runs.get()
    _close(r0["admm/z"], np.asarray(st["z"]), rtol=3e-4, atol=3e-5)
    _close(r0["admm/u"], np.asarray(st["u"]), rtol=3e-4, atol=3e-5)


def test_sharded_operators_across_processes_match_jax(runs):
    _, r0, _ = runs.get()
    A, x, y = cases.dense_inputs()
    ja = JDense(jnp.asarray(A))
    for name in ("dense rows", "dense 2x2", "dense from_blocks"):
        _close(r0[f"{name}/apply"], np.asarray(ja.apply(jnp.asarray(x))))
        _close(r0[f"{name}/adjoint"], np.asarray(ja.adjoint(jnp.asarray(y))))
    for name in ("dense rows", "dense 2x2"):
        assert np.array_equal(r0[f"{name}/mat"], A)
    rng = np.random.default_rng(4)
    mats = rng.standard_normal((4, 16, 16)).astype(np.float32)
    xb, yb = rng.standard_normal((4, 16)).astype(np.float32), rng.standard_normal((4, 16)).astype(np.float32)
    _close(r0["block diagonal/apply"], np.stack([np.asarray(JDense(jnp.asarray(m)).apply(jnp.asarray(v)))
                                                 for m, v in zip(mats, xb)]))
    _close(r0["block diagonal/adjoint"], np.stack([np.asarray(JDense(jnp.asarray(m)).adjoint(jnp.asarray(v)))
                                                   for m, v in zip(mats, yb)]))


def test_pencil_across_processes_matches_jax(runs):
    _, r0, _ = runs.get()
    rng = np.random.default_rng(5)
    xp, yp = rng.standard_normal((64, 64)).astype(np.float32), rng.standard_normal((64, 64)).astype(np.float32)
    jop = JCircular((64, 64), cases.psf("gauss7"))
    _close(r0["pencil/apply"], np.asarray(jop.apply(jnp.asarray(xp))))
    _close(r0["pencil/adjoint"], np.asarray(jop.adjoint(jnp.asarray(yp))))
    _close(r0["pencil/gram"], np.asarray(jop.adjoint(jop.apply(jnp.asarray(xp)))))
    lhs, rhs = r0["pencil/dot"]
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))
    _close(r0["pencil/pinv"], np.asarray(jop.pinv(jnp.asarray(r0["pencil/apply"]), damp=1e-3)))


def test_routed_pds_across_processes_matches_jax(runs):
    shape = (64, 64)
    filt, y, _ = cases.tv_problem(shape, "gauss7")
    A = JConvolve2D(shape, jnp.asarray(filt))
    j = jopt.PDS(shape, F=jfunc.SquaredL2Loss(shape, data=jnp.asarray(y)) * A, G=jfunc.NonNegativeOrthant(shape),
                 H=cases.LAM * jfunc.L21Norm((2,) + shape, axis=0), K=JGradient(shape))
    j = j.with_shardings(x=JaxSharding(_jmesh((4,), ("sp",)), JP("sp", None)))
    st = j.run_fixed(cases.N_IT)
    _, r0, _ = runs.get()
    scale = float(np.abs(np.asarray(st["x"])).max())
    np.testing.assert_allclose(r0["routed/x"], np.asarray(st["x"]), rtol=1e-4, atol=1e-5 * scale)
    z = np.asarray(st["z"]) if "z" in st else np.stack([np.asarray(st["z0"]), np.asarray(st["z1"])])
    np.testing.assert_allclose(r0["routed/z"], z, rtol=1e-4, atol=1e-5 * scale)


def test_checkpoint_resumes_across_process_counts(runs):
    """The two-process save (steps 20 and 40, written by the first process)
    resumed by the two processes to 60 equals the uninterrupted one-process
    solve, and so does one process resuming that save."""
    one, r0, _ = runs.get()
    assert list(r0["checkpoint/steps"]) == [20, 40, 60]
    torch.set_num_threads(1)  # as the workers
    solver = cases.build_tv("megasp", 1, max_iter=60, min_iter=1, accuracy_threshold=1e-12)
    whole = solver.solve()
    assert np.array_equal(whole["x"].numpy(), r0["checkpoint/x60"])
    assert np.array_equal(whole.history, r0["checkpoint/history"])
    resumed = solver.solve(checkpoint_dir=str(runs.two / "ckpt"))  # the newest save there: step 40
    assert resumed.n_iter == 60
    assert np.array_equal(resumed["x"].numpy(), r0["checkpoint/x60"])
    assert np.array_equal(one["checkpoint/x40"], r0["checkpoint/x40"])


# -- two processes against one, bit for bit (last: the JAX references above overlap the workers)

_GROUPS = list(cases.TV_CASES) + ["admm", "dense rows", "dense 2x2", "dense from_blocks", "block diagonal",
                                  "pencil", "routed", "checkpoint"]


@pytest.mark.parametrize("group", _GROUPS)
def test_two_processes_equal_one_process_bit_for_bit(runs, group):
    one, r0, r1 = runs.get()
    keys = [k for k in one if k.split("/")[0] == group]
    assert keys and keys == [k for k in r0 if k.split("/")[0] == group]
    for k in keys:
        for r in (r0, r1):
            assert r[k].shape == one[k].shape, k
            assert np.array_equal(r[k], one[k], equal_nan=True), (k, np.nanmax(np.abs(r[k] - one[k])))
    if f"{group}/converged_at" in one:  # the solve converged, so converged_at was compared
        assert int(one[f"{group}/converged_at"]) > 0
