"""The sharded solvers and operators of the port on a mesh of four CPU
positions, driven by one process or by two (``torch.distributed`` over
gloo): the worker of ``tests/test_torch_multiprocess_solvers.py``.

    python tests/_mp_cases.py OUT.npz              # one process, four positions
    python tests/_mp_cases.py OUT.npz COORD RANK   # one of two processes, two positions each

Each case builds its mesh of four CPU positions with the ranks of its
two-process layout (``TV_CASES``; the operators and ADMM (0, 0, 1, 1),
the 2 x 2 dense operator (0, 1, 0, 1)).  The worker imports only
``torch``, numpy and the port, writes every case's joined results to
``OUT.npz`` (``case/key``), a checkpointed solve's saves beside it, and
prints ``OK``.  Every process of the two writes its own file: the joined
results must be equal on both.
"""
import os
import shutil
import sys
import time

import numpy as np
import torch

from pycsou_tpu_torch import func as tfunc
from pycsou_tpu_torch import ops as tops
from pycsou_tpu_torch import opt as topt
from pycsou_tpu_torch.opt.admm import ConsensusADMM, stack_operators
from pycsou_tpu_torch.parallel import (
    BatchedDistributedTVDeconv2D,
    DistributedTVDeconv2D,
    Mesh,
    NamedSharding,
    PartitionSpec,
    PencilCircularConv2D,
    ShardedBlockDiagonalOperator,
    ShardedDenseOperator,
    Spatial2DTVDeconv2D,
    distributed_init,
    make_mesh,
)
from pycsou_tpu_torch.utils.device import set_default_device

LAM = 0.05
N_IT = 6  # run_fixed iterations held to the JAX package
SOLVE = dict(max_iter=200, min_iter=5, accuracy_threshold=1e-3)  # converged_at, bit for bit


def gauss(k, s=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s * s))
    return g / g.sum()


def psf(kind):
    if kind == "gauss7":
        return np.outer(gauss(7), gauss(7)).astype(np.float32)
    h = np.outer(gauss(7), gauss(7)) + 0.4 * np.outer(gauss(7, 0.8), gauss(7, 3.0))  # "rank2"
    return (h / h.sum()).astype(np.float32)


def tv_problem(shape, kind, seed=0):
    """``(filt, y, mask)`` of a TV case: a blurred or masked image of
    nonnegative noise, made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    y = np.abs(rng.standard_normal(shape)).astype(np.float32)
    if kind == "mask":
        m = (rng.random(shape) < 0.7).astype(np.float32)
        return None, m * y, m
    return psf(kind), y, None


# name: (solver, shape, PSF kind, use_pallas, mesh shape, ranks of the two-process layout)
TV_CASES = {
    "megasp": ("dist", (64, 64), "gauss7", "interpret", (4,), (0, 0, 1, 1)),
    "megarsp": ("dist", (128, 64), "rank2", "interpret", (4,), (0, 0, 1, 1)),
    "sweepsp": ("dist", (64, 64), "mask", "interpret", (4,), (0, 0, 1, 1)),
    "chain band": ("dist", (64, 64), "gauss7", False, (4,), (0, 0, 1, 1)),
    "chain fft gram": ("dist", (64, 64), "rank2", False, (4,), (0, 0, 1, 1)),
    "megar2d rows": ("2d", (64, 64), "gauss7", "interpret", (2, 2), (0, 0, 1, 1)),
    "megar2d cols": ("2d", (64, 64), "gauss7", "interpret", (2, 2), (0, 1, 0, 1)),
    "megar2d (4, 1)": ("2d", (128, 64), "gauss7", "interpret", (4, 1), (0, 0, 1, 1)),
    "2d mask chain": ("2d", (64, 64), "mask", False, (2, 2), (0, 1, 0, 1)),
    "2d rank-1 chain": ("2d", (64, 64), "gauss7", False, (2, 2), (0, 1, 0, 1)),
    "batched dp": ("batch", (64, 64), "gauss7", False, (2, 2), (0, 0, 1, 1)),
    "batched sp": ("batch", (64, 64), "gauss7", False, (2, 2), (0, 1, 0, 1)),
}
ENGINE = {"megasp": "megasp", "megarsp": "megarsp", "sweepsp": "sweepsp", "chain band": "", "chain fft gram": "",
          "megar2d rows": "megar2d", "megar2d cols": "megar2d", "megar2d (4, 1)": "megar2d", "2d mask chain": "",
          "2d rank-1 chain": ""}


def build_tv(case, world, **kw):
    kind, shape, pk, use_pallas, mshape, ranks = TV_CASES[case]
    filt, y, mask = tv_problem(shape, pk)
    if kind == "dist":
        mesh = Mesh(["cpu"] * 4, ("sp",), mshape, ranks=ranks if world == 2 else None)
        return DistributedTVDeconv2D(shape, filt, y, LAM, mesh=mesh, use_pallas=use_pallas, mask=mask, **kw)
    if kind == "2d":
        mesh = Mesh(["cpu"] * 4, ("sp0", "sp1"), mshape, ranks=ranks if world == 2 else None)
        return Spatial2DTVDeconv2D(shape, filt, y, LAM, mesh=mesh, use_pallas=use_pallas, mask=mask, **kw)
    rng = np.random.default_rng(1)
    yb = np.abs(rng.standard_normal((2,) + shape)).astype(np.float32)
    mesh = Mesh(["cpu"] * 4, ("dp", "sp"), mshape, ranks=ranks if world == 2 else None)
    return BatchedDistributedTVDeconv2D(shape, filt, yb, LAM, mesh=mesh, **kw)


def z_of(out):
    return out["z"] if "z" in out else torch.stack([out["z0"], out["z1"]], dim=-3)


def run_tv(case, world, res):
    kind = TV_CASES[case][0]
    t = build_tv(case, world)
    if case in ENGINE:
        assert t._sp_engine == ENGINE[case], (case, t._sp_engine)
    st = t.run_fixed(N_IT)
    out = t.postprocess(st)
    res[f"{case}/x"], res[f"{case}/z"] = out["x"].numpy(), z_of(out).numpy()
    res[f"{case}/history"] = st["history"][:N_IT].numpy()
    if kind != "batch":
        res[f"{case}/objective"] = t.objective(st["x"]).numpy()
    info = build_tv(case, world, **SOLVE).solve()
    res[f"{case}/solve x"], res[f"{case}/solve z"] = info["x"].numpy(), z_of(info.iterand).numpy()
    res[f"{case}/solve history"] = info.history
    res[f"{case}/converged_at"] = np.asarray(-1 if info.converged_at is None else info.converged_at)
    res[f"{case}/n_iter"] = np.asarray(info.n_iter)


def admm_problem(shape=(16, 16), S=4, seed=7):
    """S circular-convolution scenarios of one image: transfer functions
    (complex) and data, made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    h_hats, ys = [], []
    for _ in range(S):
        h = np.zeros(shape)
        h[:5, :5] = rng.standard_normal((5, 5)) / 5
        h[2, 2] += 0.5
        H = np.fft.rfft2(np.roll(h, (-2, -2), axis=(0, 1)))
        h_hats.append(H.astype(np.complex64))
        ys.append(np.fft.irfft2(np.fft.rfft2(x) * H, s=shape) + 0.01 * rng.standard_normal(shape))
    return np.stack(h_hats), np.stack(ys).astype(np.float32)


def run_admm(world, res):
    h_hats, ys = admm_problem()
    mesh = Mesh(["cpu"] * 4, ("dp",), (4,), ranks=(0, 0, 1, 1) if world == 2 else None)
    admm = ConsensusADMM((16, 16), h_hats, ys, g=tfunc.NonNegativeOrthant((16, 16)), rho=1.0, mesh=mesh)
    st = admm.run_fixed(N_IT)
    out = admm.postprocess(st)
    res["admm/z"], res["admm/u"], res["admm/history"] = out["z"].numpy(), out["u"].numpy(), \
        st["history"][:N_IT].numpy()
    info = ConsensusADMM((16, 16), h_hats, ys, g=tfunc.NonNegativeOrthant((16, 16)), rho=1.0, mesh=mesh,
                         max_iter=300, min_iter=5, accuracy_threshold=1e-4).solve()
    res["admm/solve z"], res["admm/solve history"] = info["z"].numpy(), info.history
    res["admm/converged_at"] = np.asarray(-1 if info.converged_at is None else info.converged_at)


def dense_inputs(n=64, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32), rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def run_operators(world, res):
    A, x, y = dense_inputs()
    rows = Mesh(["cpu"] * 4, ("sp",), (4,), ranks=(0, 0, 1, 1) if world == 2 else None)
    grid = Mesh(["cpu"] * 4, ("sp0", "sp1"), (2, 2), ranks=(0, 1, 0, 1) if world == 2 else None)
    for name, op in (("dense rows", ShardedDenseOperator(A, mesh=rows)),
                     ("dense 2x2", ShardedDenseOperator(A, mesh=grid, row_axis="sp0", col_axis="sp1"))):
        res[f"{name}/apply"] = op.apply(torch.from_numpy(x)).numpy()
        res[f"{name}/adjoint"] = op.adjoint(torch.from_numpy(y)).numpy()
        res[f"{name}/mat"] = op.mat.numpy()
    local = [A[p * 16 : (p + 1) * 16] for p in rows.local_positions]  # no process builds another's block
    op = ShardedDenseOperator.from_blocks(local, mesh=rows)
    res["dense from_blocks/apply"] = op.apply(torch.from_numpy(x)).numpy()
    res["dense from_blocks/adjoint"] = op.adjoint(torch.from_numpy(y)).numpy()

    # four 16 x 16 blocks of dense operators, one a position
    rng = np.random.default_rng(4)
    mats = rng.standard_normal((4, 16, 16)).astype(np.float32)
    xb, yb = rng.standard_normal((4, 16)).astype(np.float32), rng.standard_normal((4, 16)).astype(np.float32)
    ops = stack_operators([tops.DenseOperator(torch.from_numpy(m)) for m in mats])
    bd = ShardedBlockDiagonalOperator(ops, 4, mesh=Mesh(["cpu"] * 4, ("dp",), (4,),
                                                         ranks=(0, 0, 1, 1) if world == 2 else None))
    res["block diagonal/apply"] = bd.apply(torch.from_numpy(xb)).numpy()
    res["block diagonal/adjoint"] = bd.adjoint(torch.from_numpy(yb)).numpy()

    shape = (64, 64)
    rng = np.random.default_rng(5)
    xp, yp = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    pc = PencilCircularConv2D(shape, psf("gauss7"), mesh=rows)
    ax, aty = pc.apply(torch.from_numpy(xp)), pc.adjoint(torch.from_numpy(yp))
    res["pencil/apply"], res["pencil/adjoint"] = ax.numpy(), aty.numpy()
    res["pencil/dot"] = np.asarray([float(torch.sum(ax * torch.from_numpy(yp))),
                                    float(torch.sum(torch.from_numpy(xp) * aty))])
    res["pencil/pinv"] = pc.pinv(ax, damp=1e-3).numpy()
    res["pencil/gram"] = pc.gram.apply(torch.from_numpy(xp)).numpy()


def routed_pds(shape, y, filt, **kw):
    A = tops.Convolve2D(shape, filt)
    return topt.PDS(shape, F=tfunc.SquaredL2Loss(shape, data=torch.from_numpy(y)) * A,
                    G=tfunc.NonNegativeOrthant(shape), H=LAM * tfunc.L21Norm((2,) + shape, axis=0),
                    K=tops.Gradient(shape), **kw)


def run_routed(world, res):
    shape = (64, 64)
    filt, y, _ = tv_problem(shape, "gauss7")
    mesh = Mesh(["cpu"] * 4, ("sp",), (4,), ranks=(0, 0, 1, 1) if world == 2 else None)
    solver = routed_pds(shape, y, filt).with_shardings(x=NamedSharding(mesh, PartitionSpec("sp", None)))
    assert isinstance(solver._fused, DistributedTVDeconv2D), type(solver._fused)
    st = solver.run_fixed(N_IT)
    out = solver.postprocess(st)
    res["routed/x"], res["routed/z"], res["routed/history"] = out["x"].numpy(), out["z"].numpy(), \
        st["history"][:N_IT].numpy()


def run_checkpoint(world, out_dir, res):
    """megasp solved to 40 with a save every 20 iterations, then resumed to
    60 from a copy of the saves (the first process's ``ckpt``)."""
    def solver(max_iter):
        return build_tv("megasp", world, max_iter=max_iter, min_iter=1, accuracy_threshold=1e-12, verbose=20)

    first = os.path.join(out_dir, "ckpt")
    again = os.path.join(out_dir, "ckpt resumed")
    info = solver(40).solve(checkpoint_dir=first)
    res["checkpoint/x40"] = info["x"].numpy()
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        shutil.copytree(first, again, dirs_exist_ok=True)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    info = solver(60).solve(checkpoint_dir=again)
    res["checkpoint/x60"], res["checkpoint/history"] = info["x"].numpy(), info.history
    res["checkpoint/steps"] = np.asarray(sorted(int(f[5:]) for f in os.listdir(again) if f.startswith("step_")))


def main(argv):
    torch.set_num_threads(1)
    set_default_device("cpu")
    out = argv[0]
    world = 1
    if len(argv) > 1:
        coord, rank = argv[1], int(argv[2])
        distributed_init(coordinator_address=coord, num_processes=2, process_id=rank)
        world = 2
        mesh = make_mesh((4,), devices=["cpu"] * 2)
        assert mesh.ranks == (0, 0, 1, 1) and mesh.local_positions == (2 * rank, 2 * rank + 1), mesh
        assert mesh.backend == "gloo", mesh.backend
    res = {}
    t0 = time.perf_counter()
    for case in TV_CASES:
        run_tv(case, world, res)
    run_admm(world, res)
    run_operators(world, res)
    run_routed(world, res)
    run_checkpoint(world, os.path.dirname(os.path.abspath(out)), res)
    np.savez(out, **res)
    if world == 2:
        torch.distributed.destroy_process_group()
    print(f"OK {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
