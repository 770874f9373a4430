"""The port's operator leftovers against the JAX package on the CPU:
``ops/basic.py`` (dense, sparse, diagonal, polynomial), ``ops/transform.py``
(FFT, DCT, inverse DCT), ``ops/stack.py``, ``ops/kron.py``, the rest of
``core/linop.py`` (transpose, co-Gram, pseudo-inverse, projectors,
``todense``/``tosparse``, the unitary rules), ``core/map.py``'s API, the
linear and affine functionals and the separable stacks, on the same numpy
inputs.  End to end: bench.py's cfg4 (``LinOpVStack([Masking,
DCTOperator])``, ``compute_lipschitz_cst(maxiter=30)``, ``APGD`` with
``0.02 * L1Norm``) at 64 x 64, and ``examples/stacked_sparse_lowfreq.py``
at n = 512, each after 6 iterations.

Tolerances: rtol 1e-5 / atol 1e-5 for f32 elementwise code and small
products (atol 1e-4 where a 512-term product or a DCT is summed in another
order: jax.scipy's dctn against the port's rfft route); the iterates after
6 iterations within 1e-5 x max(1, max |x|); ``lipschitz`` equal to 1e-6
relative where both packages take the same closed form or numpy code, to
1e-5 from a power iteration on the same start vector.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.ops as jops
import pycsou_tpu.ops.basic as jbasic
import pycsou_tpu.ops.kron as jkron
import pycsou_tpu.ops.stack as jstack
import pycsou_tpu.ops.transform as jtr
import pycsou_tpu.opt as jopt
import pycsou_tpu.utils.opnorm as jopn
import pycsou_tpu_torch.core.functional as tfn
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
import pycsou_tpu_torch.utils.opnorm as topn
from pycsou_tpu_torch.core.linop import LinOpComp
from pycsou_tpu_torch.utils.convert import sparse_from_numpy
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


def _t(a, dtype=None):
    a = np.array(a)
    return torch.from_numpy(a.astype(dtype or (np.complex64 if np.iscomplexobj(a) else np.float32)))


def _rand(rng, shape, complex_=False):
    a = rng.standard_normal(shape).astype(np.float32)
    return (a + 1j * rng.standard_normal(shape).astype(np.float32)).astype(np.complex64) if complex_ else a


def check_op(top, jop, rng, rtol=1e-5, atol=1e-5, lip_rtol=1e-6):
    """apply, adjoint, lipschitz against JAX; the port's adjoint identity
    ``<A x, y> = <x, A^H y>``."""
    assert top.dim_shape == tuple(jop.dim_shape) and top.codim_shape == tuple(jop.codim_shape)
    cplx = top.dtype.is_complex
    x, y = _rand(rng, top.dim_shape, cplx), _rand(rng, top.codim_shape, cplx)
    ax, ahy = top.apply(_t(x)), top.adjoint(_t(y))
    np.testing.assert_allclose(ax.numpy(), np.asarray(jop.apply(jnp.asarray(x))), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ahy.numpy(), np.asarray(jop.adjoint(jnp.asarray(y))), rtol=rtol, atol=atol)
    lhs = torch.vdot(_t(y).reshape(-1), ax.reshape(-1))
    rhs = torch.vdot(ahy.reshape(-1), _t(x).reshape(-1))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4, atol=1e-3)
    if np.isfinite(jop.lipschitz):
        np.testing.assert_allclose(top.lipschitz, jop.lipschitz, rtol=lip_rtol)
    else:
        assert not np.isfinite(top.lipschitz)


# -- ops/basic.py ---------------------------------------------------------


def test_dense_operator_matches_jax(rng):
    a = rng.standard_normal((48, 30)).astype(np.float32)
    check_op(tops.DenseOperator(a, codim_shape=(6, 8), dim_shape=(5, 6)),
             jbasic.DenseOperator(jnp.asarray(a), codim_shape=(6, 8), dim_shape=(5, 6)), rng)
    c = _rand(rng, (12, 10), complex_=True)
    check_op(tops.DenseOperator(c), jbasic.DenseOperator(jnp.asarray(c)), rng)
    assert tops.ExplicitLinearOperator is tops.DenseOperator
    assert tops.DenseOperator(a).opnorm() == pytest.approx(float(jbasic.DenseOperator(jnp.asarray(a)).opnorm()),
                                                           rel=1e-6)


def test_sparse_operator_matches_jax(rng):
    """A scipy matrix, a dense array, and a JAX BCOO carried across as
    numpy (``utils.convert.sparse_from_numpy``)."""
    m = sp.random(40, 30, density=0.1, random_state=3, dtype=np.float32)
    jop = jbasic.SparseOperator(m)
    check_op(tops.SparseOperator(m), jop, rng)
    check_op(tops.SparseOperator(m.toarray()), jbasic.SparseOperator(jnp.asarray(m.toarray())), rng)
    carried = sparse_from_numpy(np.asarray(jop.mat.data), np.asarray(jop.mat.indices), jop.mat.shape)
    check_op(carried, jop, rng)
    shaped = tops.SparseOperator(m, dim_shape=(5, 6), codim_shape=(4, 10))
    check_op(shaped, jbasic.SparseOperator(m, dim_shape=(5, 6), codim_shape=(4, 10)), rng)
    assert shaped.mat_t.layout == torch.sparse_csr and tuple(shaped.mat_t.shape) == (30, 40)


def test_diagonal_and_polynomial_match_jax(rng):
    d = rng.standard_normal((6, 5)).astype(np.float32)
    D = tops.DiagonalOperator(d)
    check_op(D, jbasic.DiagonalOperator(jnp.asarray(d)), rng)
    coeffs = np.array([0.5, -1.0, 0.25], np.float32)
    JP = jbasic.PolynomialOperator(jbasic.DiagonalOperator(jnp.asarray(d)), jnp.asarray(coeffs))
    check_op(tops.PolynomialOperator(D, np.asarray(JP.coeffs)), JP, rng)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    check_op(tops.PolynomialOperator(tops.DenseOperator(a), [1.0, 2.0]),
             jbasic.PolynomialOperator(jbasic.DenseOperator(jnp.asarray(a)), [1.0, 2.0]), rng)
    I, N, Hm = tops.IdentityOperator((3,)), tops.NullOperator((3,)), tops.HomothetyOperator(-2.0, (3,))
    y = torch.tensor([1.0, 2.0, 3.0])
    assert torch.equal(I.pinv(y), y) and torch.equal(Hm.pinv(y), y / -2.0) and N.opnorm() == 0.0


# -- ops/transform.py -----------------------------------------------------


@pytest.mark.parametrize("axes", [None, (0,), (1,)])
def test_transforms_match_jax(rng, axes):
    """The port's rfft route against jax.scipy's dctn on the CPU."""
    S = (24, 20)
    check_op(tops.DCTOperator(S, axes=axes), jtr.DCTOperator(S, axes=axes), rng, atol=1e-5)
    check_op(tops.IDCTOperator(S, axes=axes), jtr.IDCTOperator(S, axes=axes), rng, atol=1e-5)
    check_op(tops.FFTOperator(S, axes=axes), jtr.FFTOperator(S, axes=axes), rng, atol=1e-5)


def test_unitary_rules(rng):
    """Gram and co-Gram the identity, pinv the adjoint, norm 1; the
    transform's own weights on its device."""
    D = tops.DCTOperator((16, 12))
    x = _t(rng.standard_normal((16, 12)))
    assert isinstance(D.gram, tops.IdentityOperator) and isinstance(D.cogram, tops.IdentityOperator)
    assert D.opnorm() == D.compute_lipschitz_cst() == 1.0
    torch.testing.assert_close(D.pinv(D(x)), x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(D.PinvOp(D(x)), x, rtol=1e-5, atol=1e-5)
    assert D.device == torch.device("cpu")


def test_unitary_prox_rule_matches_jax(rng):
    """``L1Norm * DCTOperator`` builds ProxFuncPreCompUnitOp on both sides,
    also scaled and through ``arith.compose``; the proxes agree."""
    S = (16, 12)
    tf, jf = tfunc.L1Norm(S) * tops.DCTOperator(S), jfunc.L1Norm(S) * jtr.DCTOperator(S)
    assert type(tf).__name__ == type(jf).__name__ == "ProxFuncPreCompUnitOp"
    x = rng.standard_normal(S).astype(np.float32)
    np.testing.assert_allclose(tf.prox(_t(x), 0.3).numpy(), np.asarray(jf.prox(jnp.asarray(x), 0.3)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tf(_t(x))), float(jf(jnp.asarray(x))), rtol=1e-5)
    g = 0.1 * tf
    assert type(g).__name__ == "ProxFuncPostComp"
    np.testing.assert_allclose(g.prox(_t(x), 2.0).numpy(), np.asarray((0.1 * jf).prox(jnp.asarray(x), 2.0)),
                               rtol=1e-5, atol=1e-5)
    sq = tfunc.SquaredL2Norm(S) * tops.IDCTOperator(S)
    assert isinstance(sq, tfn.DiffProxFuncPreCompUnitOp)
    torch.testing.assert_close(sq.gradient(_t(x)), 2 * _t(x), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="unitary"):
        tfn.ProxFuncPreCompUnitOp(tfunc.L1Norm((3,)), tops.DiagonalOperator(np.ones(3)))


# -- ops/stack.py ---------------------------------------------------------


def test_stacks_match_jax(rng):
    a = rng.standard_normal((7, 12)).astype(np.float32)
    d = rng.standard_normal(12).astype(np.float32)
    mask = rng.random(12) < 0.5
    ta, td = tops.DenseOperator(a), tops.DiagonalOperator(d)
    ja, jd = jbasic.DenseOperator(jnp.asarray(a)), jbasic.DiagonalOperator(jnp.asarray(d))
    check_op(tops.LinOpVStack([ta, td]), jstack.LinOpVStack([ja, jd]), rng)  # flat codomain
    check_op(tops.LinOpVStack([td, 2.0 * td]), jstack.LinOpVStack([jd, 2.0 * jd]), rng)  # (2, 12)
    check_op(tops.LinOpHStack([ta, ta.H.H]), jstack.LinOpHStack([ja, ja.H.H]), rng)
    check_op(tops.LinOpHStack([ta, tops.DenseOperator(np.ones((7, 3), np.float32))]),
             jstack.LinOpHStack([ja, jbasic.DenseOperator(jnp.ones((7, 3)))]), rng)
    check_op(tops.LinOpStack([td, td], axis=1), jstack.LinOpStack([jd, jd], axis=1), rng)
    check_op(tops.BlockDiagonalOperator([ta, td]), jstack.BlockDiagonalOperator([ja, jd]), rng)
    check_op(tops.BlockOperator([[ta, ta], [td, 3.0 * td]]), jstack.BlockOperator([[ja, ja], [jd, 3.0 * jd]]), rng)
    check_op(tops.LinOpVStack([tops.Masking((12,), mask), tops.DCTOperator((12,))]),
             jstack.LinOpVStack([jops.Masking((12,), mask), jtr.DCTOperator((12,))]), rng)


def test_map_stacks_match_jax(rng):
    """Nonlinear stacks (a functional among the blocks) and the Jacobian
    stacks of the differentiable ones."""
    S = (12,)
    x = rng.standard_normal(S).astype(np.float32)
    b = rng.standard_normal(S).astype(np.float32)
    tm = [tfunc.SquaredL2Norm(S), tops.DiagonalOperator(b)]
    jm = [jfunc.SquaredL2Norm(S), jbasic.DiagonalOperator(jnp.asarray(b))]
    for tcls, jcls in ((tops.MapVStack, jstack.MapVStack), (tops.DiffMapVStack, jstack.DiffMapVStack)):
        tv, jv = tcls(tm), jcls(jm)
        assert tv.codim_shape == tuple(jv.codim_shape) == (13,)
        np.testing.assert_allclose(tv(_t(x)).numpy(), np.asarray(jv(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    tv, jv = tops.DiffMapStack(tm, axis=0), jstack.DiffMapStack(jm, axis=0)
    assert tv.diff_lipschitz == pytest.approx(jv.diff_lipschitz, rel=1e-6)
    check_op(tv.jacobianT(_t(x)), jv.jacobianT(jnp.asarray(x)), rng)
    th = tops.DiffMapStack([tops.DiagonalOperator(b), 2.0 * tops.IdentityOperator(S)], axis=1)
    jh = jstack.DiffMapStack([jbasic.DiagonalOperator(jnp.asarray(b)), 2.0 * jbasic.IdentityOperator(S)], axis=1)
    xx = rng.standard_normal((2, 12)).astype(np.float32)
    np.testing.assert_allclose(th(_t(xx)).numpy(), np.asarray(jh(jnp.asarray(xx))), rtol=1e-5)
    check_op(th.jacobianT(_t(xx)), jh.jacobianT(jnp.asarray(xx)), rng)
    hs = tops.MapStack([tops.DiagonalOperator(b), tops.IdentityOperator(S)], axis=1)
    np.testing.assert_allclose(hs(_t(xx)).numpy(), np.asarray(jstack.MapStack(
        [jbasic.DiagonalOperator(jnp.asarray(b)), jbasic.IdentityOperator(S)], axis=1)(jnp.asarray(xx))), rtol=1e-5)


# -- ops/kron.py ----------------------------------------------------------


def test_kron_matches_jax(rng):
    a = rng.standard_normal((5, 4)).astype(np.float32)
    b = rng.standard_normal((6, 3)).astype(np.float32)
    check_op(tops.KroneckerProduct(a, b), jkron.KroneckerProduct(jnp.asarray(a), jnp.asarray(b)), rng)
    d = rng.standard_normal(3).astype(np.float32)
    check_op(tops.KroneckerProduct(tops.DenseOperator(a), tops.DiagonalOperator(d)),
             jkron.KroneckerProduct(jbasic.DenseOperator(jnp.asarray(a)), jbasic.DiagonalOperator(jnp.asarray(d))), rng)
    sa = rng.standard_normal((4, 4)).astype(np.float32)
    check_op(tops.KroneckerSum(sa, tops.DiagonalOperator(d)),
             jkron.KroneckerSum(jnp.asarray(sa), jbasic.DiagonalOperator(jnp.asarray(d))), rng)
    kb = rng.standard_normal((6, 4)).astype(np.float32)
    check_op(tops.KhatriRaoProduct(a, kb), jkron.KhatriRaoProduct(jnp.asarray(a), jnp.asarray(kb)), rng)
    # (A kron B)^+ = A^+ kron B^+: one batched CG a factor, as the
    # reference's vmap of each factor's CG; a unitary factor's is its adjoint
    K, JK = tops.KroneckerProduct(a, b), jkron.KroneckerProduct(jnp.asarray(a), jnp.asarray(b))
    y = rng.standard_normal((5, 6)).astype(np.float32)
    solves = topn.cg.host_reads
    np.testing.assert_allclose(K.pinv(_t(y), tol=1e-6).numpy(), np.asarray(JK.pinv(jnp.asarray(y), tol=1e-6)),
                               rtol=1e-4, atol=1e-4)
    assert topn.cg.host_reads - solves <= 2 * (1 + 200 // 16)
    K2 = tops.KroneckerProduct(tops.DCTOperator(5), tops.DenseOperator(b))
    JK2 = jkron.KroneckerProduct(jtr.DCTOperator(5), jbasic.DenseOperator(jnp.asarray(b)))
    np.testing.assert_allclose(K2.pinv(_t(y), tol=1e-6).numpy(), np.asarray(JK2.pinv(jnp.asarray(y), tol=1e-6)),
                               rtol=1e-4, atol=1e-4)
    xk = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_allclose(K.apply(_t(xk)).reshape(-1).numpy(), np.kron(a, b) @ xk.ravel(), rtol=1e-5, atol=1e-5)


# -- core/linop.py and core/map.py ----------------------------------------


def test_linop_api_matches_jax(rng):
    """matvec/rmatvec, T (complex: TransposeOperator), cogram, todense,
    tosparse, to_scipy_operator, the pseudo-inverse operator and the
    projectors."""
    a = rng.standard_normal((10, 6)).astype(np.float32)
    A, JA = tops.DenseOperator(a), jbasic.DenseOperator(jnp.asarray(a))
    x = rng.standard_normal(6).astype(np.float32)
    torch.testing.assert_close(A.matvec(x), A.apply(_t(x)))
    torch.testing.assert_close(A.rmatvec(_t(a @ x)), A.adjoint(_t(a @ x)))
    check_op(A.T, JA.T, rng)
    check_op(A.transpose(), JA.transpose(), rng)
    check_op(A.cogram, JA.cogram, rng, lip_rtol=1e-6)
    check_op(A.RangeGram, JA.RangeGram, rng)
    check_op(A.DomainGram, JA.DomainGram, rng)
    c = _rand(rng, (5, 4), complex_=True)
    C, JC = tops.DenseOperator(c), jbasic.DenseOperator(jnp.asarray(c))
    assert type(C.T).__name__ == type(JC.T).__name__ == "TransposeOperator"
    check_op(C.T, JC.T, rng)
    L = tops.LinOpVStack([tops.Masking((4, 5), rng.random((4, 5)) < 0.5), tops.DCTOperator((4, 5))])
    dense = L.todense()
    assert isinstance(dense, tops.DenseOperator) and dense.dim_shape == (4, 5)
    xx = _t(rng.standard_normal((4, 5)))
    torch.testing.assert_close(dense.apply(xx), L.apply(xx), rtol=1e-5, atol=1e-6)
    big = tops.DiagonalOperator(rng.standard_normal(300).astype(np.float32))  # three 128-column chunks
    torch.testing.assert_close(big.todense().mat, torch.diag(big.diag))
    sparse = L.tosparse(threshold=0.1)
    m = dense.mat.numpy()
    np.testing.assert_allclose(sparse.apply(xx).numpy(), (np.where(np.abs(m) > 0.1, m, 0) @ xx.numpy().ravel()),
                               rtol=1e-5, atol=1e-6)
    sciop = A.to_scipy_operator()
    np.testing.assert_allclose(sciop.matvec(x), a @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sciop.rmatvec(a @ x), a.T @ (a @ x), rtol=1e-5, atol=1e-5)
    y = rng.standard_normal(10).astype(np.float32)
    for t, j in ((A.PinvOp, JA.PinvOp), (A.dagger, JA.dagger)):
        np.testing.assert_allclose(t.apply(_t(y)).numpy(), np.asarray(j.apply(jnp.asarray(y))), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t.adjoint(_t(x)).numpy(), np.asarray(j.adjoint(jnp.asarray(x))), rtol=1e-4,
                                   atol=1e-4)
    for t, j in ((A.RowProjector, JA.RowProjector), (A.ColProjector, JA.ColProjector)):
        v = rng.standard_normal(t.dim_shape).astype(np.float32)
        np.testing.assert_allclose(t.apply(_t(v)).numpy(), np.asarray(j.apply(jnp.asarray(v))), rtol=1e-4, atol=1e-4)


class _Counted(tops.DiagonalOperator):
    """A diagonal operator that counts the calls of its ``apply``."""

    calls = 0

    def apply(self, x):
        type(self).calls += 1
        return super().apply(x)


@pytest.mark.parametrize("batchable,calls", [(True, 3), (False, 300)])
def test_todense_maps_128_columns_a_call(rng, monkeypatch, batchable, calls):
    """todense maps the basis through one vmapped apply a 128-column batch
    (300 columns: three), or, for an operator that is not batchable (its
    apply launches a kernel), one apply a column; the same matrix as the
    reference's."""
    d = rng.standard_normal(300).astype(np.float32)
    op = _Counted(d)
    monkeypatch.setattr(_Counted, "batchable", batchable, raising=False)
    monkeypatch.setattr(_Counted, "calls", 0)
    got = op.todense().mat
    assert _Counted.calls == calls
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbasic.DiagonalOperator(jnp.asarray(d)).todense().mat))
    stack = tops.LinOpVStack([op, tops.DCTOperator(300)])
    assert stack.batchable == batchable
    assert not LinOpComp(op, op.PinvOp).batchable  # the CG reads the host


def test_map_api_matches_jax(rng):
    """lipschitz_cst, apply_batched, argscale, ** and the diff-Lipschitz
    helpers."""
    d = rng.standard_normal(5).astype(np.float32)
    D, JD = tops.DiagonalOperator(d), jbasic.DiagonalOperator(jnp.asarray(d))
    assert D.lipschitz_cst == JD.lipschitz_cst
    D.lipschitz_cst = 7.0
    assert D.lipschitz == 7.0
    D = tops.DiagonalOperator(d)
    xs = rng.standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_allclose(D.apply_batched(_t(xs)).numpy(), np.asarray(JD.apply_batched(jnp.asarray(xs))),
                               rtol=1e-6)
    np.testing.assert_allclose(D.apply_along_axis(_t(xs)).numpy(), xs * d, rtol=1e-6)
    check_op(D.argscale(2.0), JD.argscale(2.0), rng)
    check_op(D**3, JD**3, rng)
    with pytest.raises(NotImplementedError):
        D**0
    f, jf = tfunc.SquaredL2Norm((5,)) * D, jfunc.SquaredL2Norm((5,)) * JD
    assert f.compute_diff_lipschitz_cst() == pytest.approx(jf.compute_diff_lipschitz_cst(), rel=1e-6)
    assert f.diff_lipschitz_cst == pytest.approx(jf.diff_lipschitz_cst, rel=1e-6)
    assert f.compute_lipschitz_cst() == jf.compute_lipschitz_cst()


# -- functionals ----------------------------------------------------------


def test_linear_and_affine_functionals_match_jax(rng):
    """ExplicitLinearFunctional, ``f + <a, .>`` (ProxFuncAffineSum and its
    differentiable variant) and the separable stacks."""
    v = rng.standard_normal(8).astype(np.float32)
    tl, jl = tfunc.ExplicitLinearFunctional(v), jfunc.ExplicitLinearFunctional(jnp.asarray(v))
    x = rng.standard_normal(8).astype(np.float32)
    assert float(tl(_t(x))) == pytest.approx(float(jl(jnp.asarray(x))), rel=1e-5)
    assert tl.lipschitz == jl.lipschitz
    np.testing.assert_allclose(tl.adjoint(torch.tensor(2.0)).numpy(), np.asarray(jl.adjoint(2.0)), rtol=1e-6)
    np.testing.assert_allclose(tfn.LinearFunctional.asvector(tl).numpy(), v, rtol=1e-6)
    for tf, jf in ((tfunc.L1Norm((8,)), jfunc.L1Norm((8,))), (tfunc.SquaredL2Norm((8,)), jfunc.SquaredL2Norm((8,)))):
        for ts, js in ((tf + tl, jf + jl), (tl + tf, jl + jf)):
            assert type(ts).__name__ == type(js).__name__
            assert type(ts).__name__ in ("ProxFuncAffineSum", "DiffProxFuncAffineSum")
            np.testing.assert_allclose(ts.prox(_t(x), 0.4).numpy(), np.asarray(js.prox(jnp.asarray(x), 0.4)),
                                       rtol=1e-5, atol=1e-6)
            assert float(ts(_t(x))) == pytest.approx(float(js(jnp.asarray(x))), rel=1e-5)
            assert ts.lipschitz == pytest.approx(js.lipschitz, rel=1e-6)
    ts = tfunc.SquaredL2Norm((8,)) + tl
    np.testing.assert_allclose(ts.gradient(_t(x)).numpy(),
                               np.asarray((jfunc.SquaredL2Norm((8,)) + jl).gradient(jnp.asarray(x))), rtol=1e-5)
    tp = tfunc.ProxFuncHStack([tfunc.L1Norm((3,)), tfunc.NonNegativeOrthant((5,))])
    jp = jfunc.ProxFuncHStack([jfunc.L1Norm((3,)), jfunc.NonNegativeOrthant((5,))])
    np.testing.assert_allclose(tp.prox(_t(x), 0.5).numpy(), np.asarray(jp.prox(jnp.asarray(x), 0.5)), rtol=1e-6)
    xp = np.abs(x)
    assert float(tp(_t(xp))) == pytest.approx(float(jp(jnp.asarray(xp))), rel=1e-6)
    td = tfunc.DiffFuncHStack([tfunc.SquaredL2Norm((3,)), tfunc.SquaredL2Norm((5,))])
    jd = jfunc.DiffFuncHStack([jfunc.SquaredL2Norm((3,)), jfunc.SquaredL2Norm((5,))])
    np.testing.assert_allclose(td.gradient(_t(x)).numpy(), np.asarray(jd.gradient(jnp.asarray(x))), rtol=1e-6)
    assert (td.lipschitz, td.diff_lipschitz) == (jd.lipschitz, jd.diff_lipschitz)
    assert float(td(_t(x))) == pytest.approx(float(jd(jnp.asarray(x))), rel=1e-6)


# -- end to end -----------------------------------------------------------


def _cfg4(m, mods, tfm, mask, x_true):
    """bench.py sec_cfg4_stacked's construction in one package."""
    M = mods["Masking"]((m, m), mask)
    A = mods["LinOpVStack"]([M, mods["DCTOperator"]((m, m))])
    A.compute_lipschitz_cst(maxiter=30)
    y = A(tfm(x_true))
    solver = mods["APGD"]((m, m), F=mods["SquaredL2Loss"](A.codim_shape, data=y) * A,
                          G=0.02 * mods["L1Norm"]((m, m)), max_iter=2000, min_iter=10, accuracy_threshold=1e-6)
    return A, solver


def _close_iterates(ts, js, keys):
    scale = max(1.0, float(np.abs(np.asarray(js["x"])).max()))
    for k in keys:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, atol=1e-5 * scale, err_msg=k)


def test_cfg4_matches_jax(jax_start):
    """bench.py's cfg4 at 64 x 64: ||A|| is sqrt(2) (A^H A = diag(mask) + I)
    and the JAX estimate; 6 APGD iterations match the JAX package's."""
    m = 64
    rng = np.random.default_rng(4)
    mask = (rng.random((m, m)) < 0.3).astype(np.float32)
    x_true = np.zeros((m, m), np.float32)
    x_true[rng.choice(m, 40), rng.choice(m, 40)] = 3.0
    tmods = dict(Masking=tops.Masking, LinOpVStack=tops.LinOpVStack, DCTOperator=tops.DCTOperator,
                 APGD=topt.APGD, SquaredL2Loss=tfunc.SquaredL2Loss, L1Norm=tfunc.L1Norm)
    jmods = dict(Masking=jops.Masking, LinOpVStack=jstack.LinOpVStack, DCTOperator=jtr.DCTOperator,
                 APGD=jopt.APGD, SquaredL2Loss=jfunc.SquaredL2Loss, L1Norm=jfunc.L1Norm)
    A, ts = _cfg4(m, tmods, torch.from_numpy, mask, x_true)
    JA, js = _cfg4(m, jmods, jnp.asarray, mask, x_true)
    assert A.lipschitz == pytest.approx(np.sqrt(2.0), abs=1e-5)
    assert A.lipschitz == pytest.approx(JA.lipschitz, rel=1e-6)
    assert ts.tau == pytest.approx(js.tau, rel=1e-6)
    _close_iterates(ts.run_fixed(6), js.run_fixed(6), ("x", "x_temp"))


def test_stacked_example_matches_jax(jax_start):
    """examples/stacked_sparse_lowfreq.py's problem at n = 512: the stack
    [Masking; SubSampling o DCT], its power-iteration norm, ``0.01 *
    (L1Norm * dct)`` through the unitary rule; 6 APGD iterations."""
    n = 512

    def build(pkg_ops, pkg_func, pkg_opt, VStack, arr):
        rng = np.random.default_rng(0)
        c_true = np.zeros(n, np.float32)
        c_true[rng.choice(200, 20, replace=False)] = rng.standard_normal(20).astype(np.float32)
        dct = pkg_ops.DCTOperator((n,))
        x_true = dct.adjoint(arr(c_true))
        mask = rng.uniform(size=n) < 0.3
        K = VStack([pkg_ops.Masking((n,), mask), pkg_ops.SubSampling((n,), np.arange(32)) * dct])
        K.compute_lipschitz_cst()
        y = K(x_true)
        y = y + 0.005 * arr(rng.standard_normal(y.shape).astype(np.float32))
        F = pkg_func.SquaredL2Loss(K.codim_shape, data=y) * K
        G = 0.01 * (pkg_func.L1Norm((n,)) * dct)
        return K, pkg_opt.APGD((n,), F=F, G=G, max_iter=4000, accuracy_threshold=1e-9)

    K, ts = build(tops, tfunc, topt, tops.LinOpVStack, torch.from_numpy)
    JK, js = build(jops, jfunc, jopt, jstack.LinOpVStack, jnp.asarray)
    assert type(ts.G.func).__name__ == type(js.G.func).__name__ == "ProxFuncPreCompUnitOp"
    assert K.lipschitz == pytest.approx(JK.lipschitz, rel=1e-5)
    _close_iterates(ts.run_fixed(6), js.run_fixed(6), ("x", "x_temp"))
