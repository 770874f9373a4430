"""The port's spectral estimates (``pycsou_tpu_torch/utils/opnorm.py`` and
``LinearOperator``'s ``opnorm``, ``eigenvals``, ``singularvals``,
``cond`` and ``pinv``) against the JAX package, on the CPU.

On JAX's start vector (``_rand_like`` monkeypatched to return the
``PRNGKey(key)`` draw) each estimate gives the reference's value and its
number of operator applies: the port's counted through a wrapping
operator with ``_SYNC_EVERY = 1`` (a host read before every apply), the
reference's through a ``jax.debug.callback`` in the wrapper's ``apply``.
With the port's own generator, each estimate is held to numpy's dense
SVD or eigendecomposition instead.

Tolerances: rtol 1e-5 for a power iteration or Lanczos value against the
reference's (f32 sums in another order), 1e-4 for the fold (its f32
cancellation) and the CG solves, 1e-3 against numpy's dense float64
spectrum after the estimate's own stopping tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.ops.basic as jbasic
import pycsou_tpu.utils.opnorm as jopn
import pycsou_tpu_torch.ops.basic as tbasic
import pycsou_tpu_torch.utils.opnorm as topn
from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator as JLinOp
from pycsou_tpu_torch.core.linop import LinearOperator as TLinOp
from pycsou_tpu_torch.utils.device import set_default_device


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked for the CPU: these tests
    ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture
def jax_start(monkeypatch):
    """The port's start vectors become JAX's ``PRNGKey(key)`` draws."""
    def draw(key, shape, dtype, device):
        v = jopn._rand_like(jax.random.PRNGKey(key), shape, jnp.float32)
        return torch.from_numpy(np.array(v)).to(dtype=dtype, device=device)

    monkeypatch.setattr(topn, "_rand_like", draw)


class JCount(JLinOp):
    """A JAX operator that counts its applies (at run time, inside jit)."""

    base: object = None
    counter: list = static_field(default=None)

    def __init__(self, base, counter):
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base
        self.counter = counter

    def apply(self, x):
        jax.debug.callback(self.counter.append, 1)
        return self.base.apply(x)

    def adjoint(self, y):
        return self.base.adjoint(y)


def _jcount(base):
    calls = []
    return JCount(base, calls), calls


class TCount(TLinOp):
    """The port's counterpart: counts its applies."""

    def __init__(self, base):
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base
        self.calls = 0

    def apply(self, x):
        self.calls += 1
        return self.base.apply(x)

    def adjoint(self, y):
        return self.base.adjoint(y)


def _pair(kind, rng):
    """(JAX operator, port operator, dense float64 matrix) on one input."""
    if kind == "diag":
        d = np.concatenate([[5.0, -4.0, 0.3], rng.uniform(1.0, 2.0, 57)]).astype(np.float32)
        return jbasic.DiagonalOperator(jnp.asarray(d)), tbasic.DiagonalOperator(d), np.diag(d.astype(np.float64))
    if kind == "dense":
        # singular values 6, 0.4 and 46 in [1, 3]: isolated extremes
        u, _ = np.linalg.qr(rng.standard_normal((64, 48)))
        v, _ = np.linalg.qr(rng.standard_normal((48, 48)))
        s = np.concatenate([[6.0, 0.4], rng.uniform(1.0, 3.0, 46)])
        a = ((u * s) @ v.T).astype(np.float32)
        return jbasic.DenseOperator(jnp.asarray(a)), tbasic.DenseOperator(a), a.astype(np.float64)
    raise ValueError(kind)


def _jax_call(fn, *args, **kw):
    out = fn(*args, **kw)
    jax.effects_barrier()
    return out


@pytest.mark.parametrize("kind", ["diag", "dense"])
@pytest.mark.parametrize("maxiter,tol", [(128, 1e-6), (30, 1e-6), (5, 0.0)])
def test_power_iteration_matches_jax(jax_start, rng, monkeypatch, kind, maxiter, tol):
    """The reference's value and its number of Gram applies (at most
    ``maxiter``, counting the first)."""
    jop, top, _ = _pair(kind, rng)
    jc, calls = _jcount(jop)
    want = float(_jax_call(jopn.power_iteration, jc, maxiter=maxiter, tol=tol))
    tc = TCount(top)
    monkeypatch.setattr(topn, "_SYNC_EVERY", 1)
    got, n = topn._power_iter(tc, topn._rand_like(0, top.dim_shape, top.dtype, "cpu"), maxiter, tol)
    assert tc.calls == len(calls) == int(n) <= maxiter
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # the chunked host read: the same value and count, applies to the chunk's end
    monkeypatch.setattr(topn, "_SYNC_EVERY", 16)
    tc16 = TCount(top)
    reads0 = topn.power_iteration.host_reads
    got16, n16 = topn._power_iter(tc16, topn._rand_like(0, top.dim_shape, top.dtype, "cpu"), maxiter, tol)
    assert float(got16) == float(got) and int(n16) == int(n)
    assert tc16.calls == min(maxiter, 1 + 16 * -(-(int(n) - 1) // 16))
    assert topn.power_iteration.host_reads - reads0 <= -(-(maxiter - 1) // 16)


def test_opnorm_and_lipschitz_match_jax(jax_start, rng):
    jop, top, _ = _pair("diag", rng)
    want = jop.compute_lipschitz_cst()
    assert top.compute_lipschitz_cst() == pytest.approx(want, rel=1e-5)
    assert top.lipschitz == top.diff_lipschitz == top.lipschitz_cst
    # the dense operator's exact norm, and its power iteration beyond 4e6 entries
    jd, td, a = _pair("dense", rng)
    assert td.opnorm() == pytest.approx(float(jd.opnorm()), rel=1e-6)
    assert td.opnorm() == pytest.approx(np.linalg.norm(a, 2), rel=1e-5)
    assert td.opnorm(exact=False) == pytest.approx(float(jd.opnorm(exact=False)), rel=1e-5)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_estimates_against_numpy(rng, kind):
    """The port's own start vector: the estimates against numpy's dense
    float64 spectrum."""
    _, top, a = _pair(kind, rng)
    sv = np.linalg.svd(a, compute_uv=False)
    assert (top.opnorm(exact=False) if kind == "dense" else top.opnorm()) == pytest.approx(sv[0], rel=1e-3)
    assert float(top.singularvals(k=1)[0]) == pytest.approx(sv[0], rel=1e-4)
    assert float(top.singularvals(k=1, which="SM", method="shift-invert")[0]) == pytest.approx(sv[-1], rel=1e-3)
    if kind == "diag":
        ev = np.diag(a)
        assert float(top.eigenvals(k=1)[0]) == pytest.approx(5.0, rel=1e-5)
        assert float(top.gram.eigenvals(k=1, which="SM")[0]) == pytest.approx(np.min(ev**2), rel=1e-3)
        assert top.cond() == pytest.approx(sv[0] / sv[-1], rel=1e-3)


def test_lanczos_matches_jax(jax_start, rng):
    """Lanczos runs ``m`` applies and gives the reference's Ritz values."""
    jop, top, _ = _pair("dense", rng)
    jg, tg = jop.gram, top.gram
    jc, calls = _jcount(jg)
    tc = TCount(tg)
    for which in ("LM", "LA"):
        calls.clear()
        tc.calls = 0
        want = np.asarray(_jax_call(jopn.lanczos_eigs, jc, k=2, which=which, maxiter=20))
        got = topn.lanczos_eigs(tc, k=2, which=which, maxiter=20)
        assert tc.calls == len(calls) == 20
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_arnoldi_matches_jax(jax_start, rng):
    """A non-symmetric 24 x 24 matrix: m = 24 spans the whole space, so the
    Ritz values are the eigenvalues (numpy's, to f32)."""
    a = rng.standard_normal((24, 24)).astype(np.float32)
    jc, calls = _jcount(jbasic.DenseOperator(jnp.asarray(a)))
    tc = TCount(tbasic.DenseOperator(a))
    want = np.asarray(_jax_call(jopn.arnoldi_eigs, jc, k=3, which="LM"))
    got = topn.arnoldi_eigs(tc, k=3, which="LM")
    assert tc.calls == len(calls) == 24
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    ev = np.linalg.eigvals(a.astype(np.float64))
    np.testing.assert_allclose(np.sort(np.abs(got.numpy())), np.sort(np.abs(ev))[::-1][:3][::-1], rtol=1e-4)
    assert got.dtype == torch.complex64
    for which in ("SM", "LR", "SR"):
        np.testing.assert_allclose(topn.arnoldi_eigs(tbasic.DenseOperator(a), k=1, which=which).numpy(),
                                   np.asarray(_jax_call(jopn.arnoldi_eigs, jbasic.DenseOperator(jnp.asarray(a)),
                                                        k=1, which=which)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["fold", "shift-invert"])
def test_smallest_eig_psd_matches_jax(jax_start, rng, monkeypatch, method):
    """The fold (two Lanczos runs, 2 x 24 applies) and CG shift-invert (a
    CG solve each of the 24 Lanczos steps): the reference's value, with a
    host read before every CG iteration and with the chunked read alike.

    The fold's applies equal the reference's.  Shift-invert's total CG
    iterations come within one a solve of the reference's: each solve stops
    where a float32 residual first falls under its threshold, and the last
    bit of a dot product, summed in another order, can move that by one
    iteration on the same input (``test_pinv_matches_jax`` holds the count
    exactly where no solve is that close)."""
    d = np.concatenate([[0.3, 8.0], rng.uniform(1.0, 4.0, 38)]).astype(np.float32)
    kw = dict(maxiter=24, method=method)
    jc, calls = _jcount(jbasic.DiagonalOperator(jnp.asarray(d)))
    want = _jax_call(jopn.smallest_eig_psd, jc, **kw)
    chunked = topn.smallest_eig_psd(tbasic.DiagonalOperator(d), **kw)
    monkeypatch.setattr(topn, "_SYNC_EVERY", 1)
    tc = TCount(tbasic.DiagonalOperator(d))
    got = topn.smallest_eig_psd(tc, **kw)
    if method == "fold":
        assert tc.calls == len(calls) == 48
    else:
        assert abs(tc.calls - len(calls)) <= 24
    assert got == chunked
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(0.3, rel=1e-3)


def test_pinv_matches_jax(jax_start, rng, monkeypatch):
    """CG on the normal equations: the reference's solution and its count of
    applies (one for ``r0``), with the chunked read and a read every
    iteration giving the same iterate."""
    jop, top, a = _pair("dense", rng)
    y = rng.standard_normal(64).astype(np.float32)
    for damp, tol, maxiter in ((0.0, 1e-6, 200), (0.5, 1e-4, 200), (2.0, 1e-12, 7)):
        jc, calls = _jcount(jop)
        want = np.asarray(_jax_call(jc.pinv, jnp.asarray(y), damp=damp, tol=tol, maxiter=maxiter))
        got = top.pinv(torch.from_numpy(y), damp=damp, tol=tol, maxiter=maxiter)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        rhs = top.adjoint(torch.from_numpy(y))
        applies = [0]

        def mv(v):
            applies[0] += 1
            out = top.adjoint(top.apply(v))
            return out + damp * v if damp else out

        monkeypatch.setattr(topn, "_SYNC_EVERY", 1)
        x1 = topn.cg(mv, rhs, tol=tol, maxiter=maxiter)
        assert applies[0] == len(calls) <= maxiter + 1
        monkeypatch.setattr(topn, "_SYNC_EVERY", 16)
        x16 = topn.cg(mv, rhs, tol=tol, maxiter=maxiter)
        assert torch.equal(x1, x16) and torch.equal(x16, got)
    # the damped least-squares solution itself
    x = top.pinv(torch.from_numpy(y), tol=1e-7, maxiter=500).numpy()
    np.testing.assert_allclose(x, np.linalg.lstsq(a, y.astype(np.float64), rcond=None)[0], rtol=1e-3, atol=1e-4)


def test_batched_cg_matches_vmapped_jax_cg():
    """``cg(..., batched=True)``: each row a system of its own, as the
    reference's ``jax.vmap`` of ``cg`` (rtol 1e-5), each row within 1e-6 of
    its own unbatched solve; a zero row stays zero; one host read before
    the first iteration and one every 16 after it."""
    d = torch.linspace(1.0, 100.0, 40)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 40)).astype(np.float32))
    B[2] = 0.0
    reads0, applies0 = topn.cg.host_reads, topn.cg.applies
    X = topn.cg(lambda V: d * V, B, tol=1e-6, batched=True)
    iters = topn.cg.applies - applies0 - 1
    assert topn.cg.host_reads - reads0 == 1 + iters // 16
    dj = jnp.asarray(d.numpy())
    want = jax.vmap(lambda b: jax.scipy.sparse.linalg.cg(lambda v: dj * v, b, tol=1e-6)[0])(jnp.asarray(B.numpy()))
    np.testing.assert_allclose(X.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    for b, x in zip(B, X):
        torch.testing.assert_close(x, topn.cg(lambda v: d * v, b, tol=1e-6), rtol=1e-6, atol=1e-7)
    assert torch.equal(X[2], torch.zeros(40))


def test_cg_stops_on_the_reference_rule():
    """``||r|| <= max(tol ||b||, atol)``, ``maxiter`` by default ``10 n``,
    at most one host read every 16 iterations (and one before the first)."""
    d = torch.linspace(1.0, 100.0, 50)
    b = torch.ones(50)
    reads0, applies0 = topn.cg.host_reads, topn.cg.applies
    x = topn.cg(lambda v: d * v, b, tol=1e-6)
    assert float(torch.linalg.vector_norm(d * x - b)) <= 1e-6 * float(torch.linalg.vector_norm(b)) * 1.01
    iters = topn.cg.applies - applies0 - 1
    assert topn.cg.host_reads - reads0 == 1 + iters // 16
    want = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(d.numpy()) * v, jnp.ones(50), tol=1e-6)[0]
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-5)
    # b = 0: no iteration, x0 back after one read
    reads0 = topn.cg.host_reads
    assert torch.equal(topn.cg(lambda v: d * v, torch.zeros(50)), torch.zeros(50))
    assert topn.cg.host_reads - reads0 == 1


def test_start_vector_is_the_same_on_every_device():
    """One key, one start: the CPU generator's draw, moved to the device."""
    a = topn._rand_like(3, (4, 5), torch.float32, "cpu")
    b = topn._rand_like(3, (4, 5), torch.float32, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, topn._rand_like(4, (4, 5), torch.float32, "cpu"))
    c = topn._rand_like(3, (4,), torch.complex64, "cpu")
    assert c.dtype == torch.complex64 and float(c.imag.abs().sum()) > 0
