"""``parallel/sharded.py`` and ``parallel/fft.py`` of the port against the JAX
package, on the CPU.

The twins of ``tests/test_pencil_fft.py`` (all seven) and of the four
sharded cases of ``tests/test_sharded_ops.py``: the port's meshes hold
``devices=["cpu"] * n`` (four, or eight where the layout depends on the
count), the JAX side's the conftest's eight virtual devices, as the
reference's tests.
Each operator against its JAX counterpart on the same numpy inputs within
rtol 1e-4 / atol 1e-5 max|out| (the pencil pinv 1e-5 / 1e-6, as the
reference's test), each adjoint pair by the dot test (rtol 1e-4).  The
port's own: ``ShardedBlockDiagonalOperator`` of band ``Convolve2D`` blocks
(K1's plain version here) against the blocks applied one by one, and
``from_blocks`` placing each block on its position's device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as JP

import pycsou_tpu.func as jfunc
import pycsou_tpu.opt as jopt
from pycsou_tpu.ops.basic import DenseOperator as JDense
from pycsou_tpu.ops.conv import CircularConvolve as JCircular
from pycsou_tpu.opt.admm import stack_operators as jstack
from pycsou_tpu.parallel import PencilCircularConv2D as JPencil
from pycsou_tpu.parallel import ShardedDenseOperator as JShardedDense
from pycsou_tpu.parallel.fft import pencil_irfft2 as jirfft2
from pycsou_tpu.parallel.fft import pencil_rfft2 as jrfft2
from pycsou_tpu.parallel.sharded import ShardedBlockDiagonalOperator as JBlockDiag
import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.opt.admm import stack_operators
from pycsou_tpu_torch.parallel import (
    NamedSharding,
    PartitionSpec,
    PencilCircularConv2D,
    ShardedBlockDiagonalOperator,
    ShardedDenseOperator,
    make_mesh,
    pencil_irfft2,
    pencil_rfft2,
)
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


def _gauss(k, s=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    f = np.outer(g, g).astype(np.float32)
    return f / f.sum()


def _close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _mesh(n, names=("sp",), shape=None):
    return make_mesh(shape or (n,), names, devices=["cpu"] * n)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _dot_test(op, rng, rtol=1e-4):
    """<A x, y> == <x, A^H y>."""
    for _ in range(3):
        x = _t(rng.standard_normal(op.dim_shape))
        y = _t(rng.standard_normal(op.codim_shape))
        lhs, rhs = float(torch.sum(op.apply(x) * y)), float(torch.sum(x * op.adjoint(y)))
        assert abs(lhs - rhs) <= rtol * max(1.0, abs(lhs))


# -- the pencil FFT (tests/test_pencil_fft.py) -----------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (64, 64), (32, 50)])
def test_pencil_rfft2_matches_global(rng, shape):
    H, W = shape
    x = rng.standard_normal(shape).astype(np.float32)
    mesh = _mesh(8)
    pencils = pencil_rfft2(NamedSharding(mesh, PartitionSpec("sp", None)).split(_t(x)), mesh)
    got = torch.cat(pencils, dim=1).numpy()
    jm = _jmesh((8,), ("sp",))

    def fwd(block):
        S = jrfft2(block, "sp")
        return jnp.real(S), jnp.imag(S)

    re, im = jax.jit(shard_map(fwd, mesh=jm, in_specs=(JP("sp", None),), out_specs=(JP(None, "sp"),) * 2))(
        jnp.asarray(x))
    want = np.asarray(re) + 1j * np.asarray(im)
    assert got.shape == want.shape
    _close(got.real, want.real, rtol=2e-4, atol=1e-5)
    _close(got.imag, want.imag, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, : W // 2 + 1], np.fft.rfft2(x), rtol=2e-4, atol=1e-3)
    assert np.all(got[:, W // 2 + 1 :] == 0)


def test_pencil_roundtrip_identity(rng):
    H, W = 64, 80
    x = rng.standard_normal((H, W)).astype(np.float32)
    mesh = _mesh(8)
    sh = NamedSharding(mesh, PartitionSpec("sp", None))
    y = sh.join(pencil_irfft2(pencil_rfft2(sh.split(_t(x)), mesh), mesh, W))
    jm = _jmesh((8,), ("sp",))
    jy = jax.jit(shard_map(lambda b: jirfft2(jrfft2(b, "sp"), "sp", W).astype(jnp.float32), mesh=jm,
                           in_specs=(JP("sp", None),), out_specs=JP("sp", None)))(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), x, rtol=1e-5, atol=1e-5)
    _close(y, jy)


def test_pencil_circular_conv_matches_single_device(rng):
    H, W = 64, 96
    filt = _gauss(9)
    x = rng.standard_normal((H, W)).astype(np.float32)
    op = PencilCircularConv2D((H, W), filt, mesh=_mesh(4))
    jop = JPencil((H, W), filt, mesh=_jmesh((8,), ("sp",)))
    ref = tops.CircularConvolve((H, W), filt)
    jx = jnp.asarray(x)
    _close(op.apply(_t(x)), jop.apply(jx))
    _close(op.adjoint(_t(x)), jop.adjoint(jx))
    _close(op.gram.apply(_t(x)), jop.gram.apply(jx))
    _close(op.apply(_t(x)), ref.apply(_t(x)))
    _close(op.gram.apply(_t(x)), ref.adjoint(ref.apply(_t(x))))
    assert abs(op.lipschitz - ref.lipschitz) < 1e-6 and abs(op.lipschitz - jop.lipschitz) < 1e-6
    assert abs(op.gram.lipschitz - op.lipschitz**2) < 1e-12


def test_pencil_circular_conv_dot_test(rng):
    op = PencilCircularConv2D((32, 48), _gauss(7), mesh=_mesh(4))
    _dot_test(op, rng)
    _dot_test(op.gram, rng)


def test_pencil_pinv_matches_single_device(rng):
    H, W = 32, 64
    filt = _gauss(7)
    op = PencilCircularConv2D((H, W), filt, mesh=_mesh(4))
    ref = tops.CircularConvolve((H, W), filt)
    jop = JPencil((H, W), filt, mesh=_jmesh((8,), ("sp",)))
    x = rng.standard_normal((H, W)).astype(np.float32)
    y = op.apply(_t(x))
    a = op.pinv(y, damp=1e-4)
    np.testing.assert_allclose(a.numpy(), ref.pinv(y, damp=1e-4).numpy(), rtol=1e-5, atol=1e-6 * float(a.abs().max()))
    np.testing.assert_allclose(a.numpy(), np.asarray(jop.pinv(jnp.asarray(y.numpy()), damp=1e-4)), rtol=1e-4,
                               atol=1e-5 * float(a.abs().max()))


def test_pencil_requires_divisible_rows():
    with pytest.raises(ValueError):
        PencilCircularConv2D((30, 64), _gauss(5), mesh=_mesh(4))
    with pytest.raises(ValueError):
        JPencil((30, 64), _gauss(5))


def test_pencil_in_generic_sharded_solver(rng):
    """Circular deconvolution by ``APGD.with_shardings`` over the pencil
    Gram, against the unsharded ``APGD`` over ``CircularConvolve`` and the
    JAX package's sharded solve."""
    H, W = 32, 48
    filt = _gauss(7)
    mesh = _mesh(4)
    op = PencilCircularConv2D((H, W), filt, mesh=mesh)
    x_true = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    y = op.apply(_t(x_true))

    def solve(A, sharded):
        s = topt.APGD((H, W), F=tfunc.SquaredL2Loss((H, W), data=y) * A, x0=torch.zeros(H, W), max_iter=60,
                      min_iter=60)
        return (s.with_shardings(x=NamedSharding(mesh, PartitionSpec("sp", None))) if sharded else s).solve()

    got = solve(op, True)
    assert got.n_iter == 60
    _close(got["x"], solve(tops.CircularConvolve((H, W), filt), False)["x"], rtol=1e-3, atol=1e-4)
    jm = _jmesh((8,), ("sp",))
    jop = JPencil((H, W), filt, mesh=jm)
    jinfo = jopt.APGD((H, W), F=jfunc.SquaredL2Loss((H, W), data=jnp.asarray(y.numpy())) * jop,
                      x0=jnp.zeros((H, W), jnp.float32), max_iter=60, min_iter=60).with_shardings(
        x=JaxSharding(jm, JP("sp", None))).solve()
    _close(got["x"], jinfo["x"])


# -- the sharded explicit operators (tests/test_sharded_ops.py) -----------------------


def test_sharded_dense_matches_local(rng):
    M = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal(48).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)
    mesh = _mesh(4)
    op = ShardedDenseOperator(M, mesh=mesh, row_axis="sp")
    assert len(op.blocks) == 4 and tuple(op.blocks[0].shape) == (16, 48)
    jop = JShardedDense(M, mesh=_jmesh((8,), ("sp",)), row_axis="sp")
    _close(op(_t(x)), M @ x)
    _close(op(_t(x)), jop(jnp.asarray(x)))
    _close(op.adjoint(_t(y)), M.T @ y)
    _close(op.adjoint(_t(y)), jop.adjoint(jnp.asarray(y)))
    _dot_test(op, rng)
    op2 = ShardedDenseOperator(M, mesh=_mesh(4, ("cols",)), row_axis=None, col_axis="cols")
    assert tuple(op2.blocks[0].shape) == (64, 12)
    jop2 = JShardedDense(M, mesh=_jmesh((8,), ("cols",)), row_axis=None, col_axis="cols")
    _close(op2(_t(x)), M @ x)
    _close(op2(_t(x)), jop2(jnp.asarray(x)))
    _close(op2.adjoint(_t(y)), M.T @ y)
    assert torch.equal(op.mat, _t(M)) and torch.equal(op2.mat, _t(M))


def test_sharded_dense_from_blocks(rng):
    mesh = _mesh(8)
    blocks = [rng.standard_normal((2, 10)).astype(np.float32) for _ in range(8)]
    op = ShardedDenseOperator.from_blocks(blocks, mesh=mesh)
    jop = JShardedDense.from_blocks(blocks, mesh=_jmesh((8,), ("sp",)))
    M = np.concatenate(blocks, axis=0)
    x = rng.standard_normal(10).astype(np.float32)
    y = rng.standard_normal(16).astype(np.float32)
    assert op.dim_shape == (10,) and op.codim_shape == (16,) and op.row_axis == "sp" and op.col_axis is None
    assert all(b.device == d for b, d in zip(op.blocks, mesh.devices))
    _close(op(_t(x)), M @ x)
    _close(op(_t(x)), jop(jnp.asarray(x)))
    _close(op.adjoint(_t(y)), M.T @ y)
    _close(op.adjoint(_t(y)), jop.adjoint(jnp.asarray(y)))
    with pytest.raises(ValueError):
        ShardedDenseOperator.from_blocks(blocks[:7], mesh=mesh)


def test_sharded_dense_2d_mesh(rng):
    M = rng.standard_normal((16, 12)).astype(np.float32)
    x = rng.standard_normal(12).astype(np.float32)
    y = rng.standard_normal(16).astype(np.float32)
    op = ShardedDenseOperator(M, mesh=_mesh(4, ("r", "c"), (2, 2)), row_axis="r", col_axis="c")
    assert len(op.blocks) == 4 and tuple(op.blocks[0].shape) == (8, 6)
    jop = JShardedDense(M, mesh=_jmesh((2, 4), ("r", "c")), row_axis="r", col_axis="c")
    _close(op.apply(_t(x)), M @ x)
    _close(op.apply(_t(x)), jax.jit(jop.apply)(jnp.asarray(x)))
    _close(op.adjoint(_t(y)), M.T @ y)
    _close(op.adjoint(_t(y)), jax.jit(jop.adjoint)(jnp.asarray(y)))
    _dot_test(op, rng)
    sp = op.tosparse()
    _close(sp(_t(x)), M @ x)


def test_sharded_block_diagonal(rng):
    S, m, n = 8, 6, 5
    mats = [rng.standard_normal((m, n)).astype(np.float32) for _ in range(S)]
    B = ShardedBlockDiagonalOperator(stack_operators([tops.DenseOperator(M) for M in mats]), n_blocks=S,
                                     mesh=_mesh(4, ("dp",)))
    assert B.dim_shape == (S, n) and B.codim_shape == (S, m)
    jB = JBlockDiag(jstack([JDense(jnp.asarray(M)) for M in mats]), n_blocks=S, mesh=_jmesh((8,), ("dp",)))
    x = rng.standard_normal((S, n)).astype(np.float32)
    got = B(_t(x))
    _close(got, np.stack([M @ x[i] for i, M in enumerate(mats)]))
    _close(got, jB(jnp.asarray(x)))
    _dot_test(B, rng)
    with pytest.raises(ValueError):
        ShardedBlockDiagonalOperator(stack_operators([tops.DenseOperator(M) for M in mats[:6]]), n_blocks=6,
                                     mesh=_mesh(4, ("dp",)))


def test_sharded_block_diagonal_of_band_convolutions(rng):
    """Band ``Convolve2D`` blocks (K1 on the card, its plain version here),
    two a position, against the blocks applied one by one, bit for bit."""
    S, shape = 8, (32, 40)
    ops = stack_operators([tops.Convolve2D(shape, _gauss(5, 0.8 + 0.2 * i)) for i in range(S)])
    assert all(op.method == "band" for op in ops)
    B = ShardedBlockDiagonalOperator(ops, n_blocks=S, mesh=_mesh(4, ("dp",)))
    x = _t(rng.standard_normal((S,) + shape))
    assert torch.equal(B.apply(x), torch.stack([op.apply(x[i]) for i, op in enumerate(ops)]))
    assert torch.equal(B.adjoint(x), torch.stack([op.adjoint(x[i]) for i, op in enumerate(ops)]))
    assert not B.batchable and B.lipschitz == max(op.lipschitz for op in ops)
