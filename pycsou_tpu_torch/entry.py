"""Entry points of the port (the twin of the JAX package's
``__graft_entry__.py``).

``entry()``             one fused ``PDS`` iteration of the flagship problem
                        (TV-regularised 2-D deconvolution at 128 x 128, a
                        7 x 7 Gaussian PSF) and its arguments: on a card the
                        step launches the engine ladder's pick, on the CPU the
                        plain engine.
``dryrun_multichip(n)`` one step of each multi-device path on a mesh of
                        ``n`` positions at small shapes: the one card
                        repeated, or ``n`` CPU positions with
                        ``device="cpu"``; prints the paths that ran.

    python -m pycsou_tpu_torch.entry [--device cpu] [--n 4]

The reference's path "2c" (the generic ``PDS`` with its state cut by
GSPMD) has no counterpart: the port has no SPMD partitioner, and its
``with_shardings`` keeps the generic chain's state whole on the mesh's
first device.  The printout says so.
"""
import argparse

import numpy as np
import torch

from pycsou_tpu_torch.utils.device import as_tensor, resolve_device

NO_SPMD = ("2c: not run: the port has no SPMD partitioner (ROADMAP.md Queue 3, deliberate differences, "
           "'No SPMD partitioner'); with_shardings keeps the generic chain's state whole on the mesh's first device")


def _gaussian_kernel(k=7, sigma=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def _flagship_solver(shape=(128, 128), ksize=7, seed=0, device=None):
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D, Gradient
    from pycsou_tpu_torch.opt import PDS

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    h = _gaussian_kernel(ksize)
    A = Convolve2D(shape, h, device=dev)
    x_true = as_tensor(np.abs(rng.standard_normal(shape)).astype(np.float32), dev)
    y = A(x_true) + 0.01 * as_tensor(rng.standard_normal(shape).astype(np.float32), dev)

    F = SquaredL2Loss(shape, data=y) * A
    K = Gradient(shape)
    H = 0.05 * L21Norm((2,) + shape, axis=0)
    return PDS(shape, F=F, G=NonNegativeOrthant(shape), H=H, K=K, max_iter=100)


def entry(device=None):
    """``(fn, (solver, state))``: ``fn(solver, state)`` is one fused
    ``PDS`` iteration (``solver.step``) of the flagship problem from its
    initial state."""
    solver = _flagship_solver(device=device)
    state = solver._wrap_state(solver.initial_state())

    def fn(solver, state):
        return solver.step(state)

    return fn, (solver, state)


def dryrun_multichip(n_devices: int, device=None) -> list:
    """One step of each multi-device path of the reference's dry run on a
    mesh of ``n_devices`` positions of ``device`` (the default device: the
    card, each position the card again; ``"cpu"``: CPU positions, the fused
    shard engines as their plain versions).  Prints and returns the paths
    that ran."""
    from pycsou_tpu_torch.func import L1Norm
    from pycsou_tpu_torch.ops import CircularConvolve, DenseOperator
    from pycsou_tpu_torch.opt.admm import ConsensusADMM, stack_operators
    from pycsou_tpu_torch.parallel import (
        BatchedDistributedTVDeconv2D,
        DistributedTVDeconv2D,
        NamedSharding,
        PartitionSpec as P,
        PencilCircularConv2D,
        Spatial2DTVDeconv2D,
        make_mesh,
    )

    dev = resolve_device(device)
    fused = "auto" if dev.type == "cuda" else "interpret"  # the shard engines, or their plain versions
    rng = np.random.default_rng(0)
    positions = [dev] * n_devices
    paths = []

    # -- path 1: sharded PDS on the banded halo Gram (the chain) ----------
    mesh_sp = make_mesh((n_devices,), ("sp",), devices=positions)
    H, W = 8 * n_devices, 16
    h = _gaussian_kernel(5)
    y = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    dist = DistributedTVDeconv2D((H, W), h, y, lam=0.05, nonneg=True, mesh=mesh_sp, use_pallas=False)
    if not dist._use_band or dist._sp_engine:
        raise AssertionError("the Gaussian PSF must take the banded distributed Gram on the chain")
    x, z = dist.run(1)
    _check(x, (H, W))
    paths.append("1: sp-sharded PDS, banded halo Gram")

    # -- path 2: data-parallel consensus ADMM (the block sums folded) -----
    mesh_dp = make_mesh((n_devices,), ("dp",), devices=positions)
    shape = (8, 8)
    h_hats, ys = [], []
    for _ in range(n_devices):
        op = CircularConvolve(shape, _gaussian_kernel(3, 1.0), device=dev)
        h_hats.append(op.h_hat)
        ys.append(rng.standard_normal(shape).astype(np.float32))
    admm = ConsensusADMM(shape, torch.stack(h_hats), np.stack(ys), g=0.1 * L1Norm(shape), rho=1.0, mesh=mesh_dp)
    _check(admm.run(1), shape)
    paths.append("2: dp consensus ADMM (block sums folded in mesh order)")

    # -- path 1b: the fused shard engine megasp (K14) ---------------------
    Hp, Wp = 32 * n_devices, 384
    yp = np.abs(rng.standard_normal((Hp, Wp))).astype(np.float32)
    dist_p = DistributedTVDeconv2D((Hp, Wp), h, yp, lam=0.05, nonneg=True, mesh=mesh_sp, use_pallas=fused)
    _engine(dist_p, "megasp")
    xp, _ = dist_p.run(1)
    _check(xp, (Hp, Wp))
    paths.append("1b: megasp fused per-shard engine (K14)")

    # -- path 1c: the rank-2 PSF's shard engine megarsp (K15) -------------
    h2 = np.outer(_gaussian_kernel(5)[:, 2], _gaussian_kernel(5)[2]) + 0.3 * np.outer(
        _gaussian_kernel(5, 0.7)[:, 2], _gaussian_kernel(5, 3.0)[2]
    )
    h2 = (h2 / h2.sum()).astype(np.float32)
    dist_r = DistributedTVDeconv2D((Hp, Wp), h2, yp, lam=0.05, nonneg=True, mesh=mesh_sp, use_pallas=fused)
    _engine(dist_r, "megarsp")
    xr, _ = dist_r.run(1)
    _check(xr, (Hp, Wp))
    paths.append("1c: megarsp rank-2 per-shard engine (K15)")

    # -- path 2b: the distributed stopping metric (solve on the mesh) -----
    dist2 = DistributedTVDeconv2D((H, W), h, y, lam=0.05, mesh=mesh_sp, max_iter=3, min_iter=1,
                                  accuracy_threshold=0.0, use_pallas=fused)
    info = dist2.solve()
    # the first entry is inf by convention (x moved off the zero start)
    if info.n_iter != 3 or not np.isfinite(np.asarray(info.history[1:])).all():
        raise AssertionError(f"distributed solve: {info.n_iter} iterations, history {info.history}")
    paths.append("2b: distributed stopping metric solve")

    # -- path 2c: the GSPMD-sharded generic PDS has no counterpart --------
    # -- path 2c2: the generic PDS re-dispatched by its shardings onto ----
    # DistributedTVDeconv2D (the same user expression)
    routed = _flagship_solver(shape=(8 * n_devices, 16), ksize=5, device=dev)
    routed = routed.with_shardings(x=NamedSharding(mesh_sp, P("sp", None)))
    if not isinstance(routed._fused, DistributedTVDeconv2D):
        raise AssertionError(f"with_shardings routed onto {type(routed._fused).__name__}")
    rstate = routed.run_fixed(1)
    if not isinstance(rstate["x"], tuple) or len(rstate["x"]) != n_devices:
        raise AssertionError("the routed state must hold one block a position")
    paths.append("2c2: sharded generic PDS -> DistributedTVDeconv2D delegate")

    # -- path 2c3: distributed inpainting on sweepsp (K16) ----------------
    Hm, Wm = 32 * n_devices, 256
    keep = rng.random((Hm, Wm)) < 0.5
    mmask = keep.astype(np.float32)
    ym = mmask * np.abs(rng.standard_normal((Hm, Wm))).astype(np.float32)
    dist_m = DistributedTVDeconv2D((Hm, Wm), None, ym, lam=0.05, nonneg=True, mesh=mesh_sp, mask=mmask,
                                   use_pallas=fused)
    _engine(dist_m, "sweepsp")
    xm, _ = dist_m.run(1)
    _check(xm, (Hm, Wm))
    paths.append("2c3: distributed inpainting (masked sweepsp engine, K16)")

    # -- path 2d: consensus ADMM with the CG x-update (any A_i) -----------
    nn = 8
    ops = [DenseOperator(rng.standard_normal((12, nn)).astype(np.float32), device=dev) for _ in range(n_devices)]
    ycg = rng.standard_normal((n_devices, 12)).astype(np.float32)
    admm_cg = ConsensusADMM((nn,), ops=stack_operators(ops), data=ycg, rho=1.0, mesh=mesh_dp)
    _check(admm_cg.run(1), (nn,))
    paths.append("2d: consensus ADMM w/ CG x-update")

    # -- path 2e: the pencil-decomposed distributed FFT (all-to-all) ------
    pc = PencilCircularConv2D((8 * n_devices, 16), _gaussian_kernel(5), mesh=mesh_sp)
    _check(pc.gram.apply(as_tensor(y, dev)), (H, W))
    paths.append("2e: pencil-decomposed distributed FFT")

    # -- path 3: a 2-D (dp, sp) mesh: batched and row-sharded -------------
    if n_devices % 2 == 0 and n_devices >= 4:
        n_dp, n_sp = 2, n_devices // 2
        mesh2d = make_mesh((n_dp, n_sp), ("dp", "sp"), devices=positions)
        Hb, Wb, B = 4 * n_sp, 16, 2 * n_dp
        yb = np.abs(rng.standard_normal((B, Hb, Wb))).astype(np.float32)
        batched = BatchedDistributedTVDeconv2D((Hb, Wb), _gaussian_kernel(3, 1.0), yb, lam=0.05, mesh=mesh2d)
        xb, _ = batched.run(1)
        _check(xb, (B, Hb, Wb))
        paths.append("3: dp x sp batched spatial mesh")

        # -- path 3b: a 2-D spatial mesh (sp0, sp1) on one image ----------
        mesh_sp2 = make_mesh((2, n_devices // 2), ("sp0", "sp1"), devices=positions)
        Hs, Ws = 2 * 8, (n_devices // 2) * 8
        ys2 = np.abs(rng.standard_normal((Hs, Ws))).astype(np.float32)
        sp2 = Spatial2DTVDeconv2D((Hs, Ws), _gaussian_kernel(5), ys2, lam=0.05, mesh=mesh_sp2)
        xs2, _ = sp2.run(1)
        _check(xs2, (Hs, Ws))
        paths.append("3b: sp0 x sp1 2-D spatial mesh")

        # -- path 3c: the fused block engine megar2d (K17) ----------------
        Hs2, Ws2 = 2 * 32, (n_devices // 2) * 128
        ys3 = np.abs(rng.standard_normal((Hs2, Ws2))).astype(np.float32)
        sp2f = Spatial2DTVDeconv2D((Hs2, Ws2), _gaussian_kernel(5), ys3, lam=0.05, mesh=mesh_sp2,
                                   use_pallas=fused)
        _engine(sp2f, "megar2d")
        xs2f, _ = sp2f.run(1)
        _check(xs2f, (Hs2, Ws2))
        paths.append("3c: megar2d fused engine on the sp0 x sp1 mesh (K17)")
    print(f"dryrun_multichip({n_devices}) on {dev.type} OK: {len(paths)} paths executed")
    for p in paths:
        print(f"  path {p}")
    print(f"  path {NO_SPMD}")
    return paths


def _engine(solver, want):
    if solver._sp_engine != want:
        raise AssertionError(f"{type(solver).__name__} took {solver._sp_engine!r}, not {want!r}")


def _check(out, shape):
    if tuple(out.shape) != tuple(shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"expected finite values of shape {shape}, got {tuple(out.shape)}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu", or the card (the default)')
    parser.add_argument("--n", type=int, default=4, help="mesh positions of the dry run")
    args = parser.parse_args(argv)
    fn, (solver, state) = entry(args.device)
    out = fn(solver, state)
    print(f"entry() step OK on {out['x'].device}: engine {solver._fused.stencil_mode}")
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
