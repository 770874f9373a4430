#!/usr/bin/env python
"""Smoke test of pycsou_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and the time to build the CUDA kernels from
   ``pycsou_tpu_torch/csrc``.
2. Runs every kernel of the port (K1-K7) at 4096 x 4096 with the
   benchmark's 15 x 15 Gaussian PSF and its rank-2 PSF and its 70% keep
   mask, against the plain PyTorch version on the same inputs: max abs /
   rel error against the stated tolerance, median CUDA-event times of
   kernel and plain, and the device-to-device copy of the kernels' image
   streams (their floor).
3. Drives the main path through the user's entry point, the README's
   ``PDS`` expression at 4096 x 4096 on the benchmark's problem, with the
   launch counters zeroed just before it and read just after: it must
   fuse onto ``TVDeconvolution[megar]``, launch K1 for ``A^H y`` and K4
   once per iteration, and nothing else.  On a piecewise-constant image
   with the same blur and noise it must recover x better than the blurred
   observation.  The generic chain (``fuse=False``, K2) and the sweep
   engine (K2 + K3), each counted on its own, must agree with megar.
4. Drives the masked paths at 4096 x 4096 the same way, each counted on
   its own run: inpainting (``SquaredL2Loss * Masking``) and zero-fill
   super-resolution (``* DownSampling``) fused onto
   ``TVDeconvolution[sweepm2]`` (K6, one launch per two iterations, nothing
   else), blurred super-resolution (``* (Masking * Convolve2D)``) fused
   onto ``[megarm]`` (K7 once per iteration, K1 for ``A^H y`` only), and
   large denoising by ``PDS`` and by ``CPS`` (K6).  Each must recover the
   piecewise-constant image better than its observation.  Cross-checks:
   sweepm2 against sweepm (K5) and the generic chain, megarm against the
   generic chain.
5. The slope-timed iterations/s of the main path and of the inpainting,
   blurred super-resolution and denoising paths, and the main path's
   ``solve()`` time to a 1e-6 relative improvement.

Any failure exits non-zero.  On success the last two lines are a JSON
object with the per-kernel results and the device line
``{"ok": true, "device": {...}}``.  In the results, ``kernels`` holds the
kernels of the main paths (K1, K4 on the README's path, K6 on inpainting,
K7 on blurred super-resolution) with the launches of the run named in
``run``; ``off_main_path_kernels`` holds K2, K3 and K5 with the launches of
their own runs.  Without CUDA it exits 2 and prints no result.
"""
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (4096, 4096)
KSIZE = 15
LAM = 0.05
SEED = 0
ITERS = 100
# kernels vs plain versions: f32 sums in another order; the error bound is
# relative to the larger of 1 and the largest magnitude of the result
TOL_REL = 1e-5
TOL_STATS = 1e-5  # metric partial sums (per-block f32, folded in f64)
TOL_PATH = 1e-4  # iterates of two engines after a few iterations

KERNELS = {
    "K1": ("sepconv2d", "pycsou_tpu_torch/csrc/conv2d.cu", "pycsou_tpu/kernels/conv2d.py:273"),
    "K2": ("sepgram2d", "pycsou_tpu_torch/csrc/conv2d.cu", "pycsou_tpu/kernels/conv2d.py:391"),
    "K3": ("tv_pds_sweep_step_stats", "pycsou_tpu_torch/csrc/tv.cu", "pycsou_tpu/kernels/tv.py:395"),
    "K4": ("tv_pds_megar_step", "pycsou_tpu_torch/csrc/tvr.cu", "pycsou_tpu/kernels/tvr.py:352"),
    "K5": ("tv_pds_sweepm_step_stats", "pycsou_tpu_torch/csrc/tv.cu", "pycsou_tpu/kernels/tv.py:476"),
    "K6": ("tv_pds_sweepm2_step", "pycsou_tpu_torch/csrc/tvm2.cu", "pycsou_tpu/kernels/tv.py:623"),
    "K7": ("tv_pds_megarm_step", "pycsou_tpu_torch/csrc/tvr.cu", "pycsou_tpu/kernels/tvr.py:352"),
}
# each kernel of a main path -> the run that counts its launches: the
# README's PDS (TVDeconvolution[megar]) runs K1 (A^H y) and K4, inpainting
# [sweepm2] K6, blurred super-resolution [megarm] K7
MAIN_PATH_KERNELS = {"K1": "main path", "K4": "main path", "K6": "inpainting",
                     "K7": "blurred super-resolution"}
OFF_MAIN_PATH_KERNELS = {"K2": "PDS fuse=False", "K3": "TVDeconvolution stencil='sweep'",
                         "K5": "TVDeconvolution stencil='sweepm'"}


def log(*a):
    print(*a, flush=True)


def gaussian_kernel(k=KSIZE, sigma=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def rank2_kernel(k=KSIZE):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))  # noqa: E731
    h2 = np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))
    return (h2 / h2.sum()).astype(np.float32)


def make_problem(rng, shape=SHAPE):
    """The benchmark's problem (bench.py make_problem), with x_true kept:
    white |N(0, 1)| noise blurred by the Gaussian PSF, plus 0.01 noise."""
    from scipy.signal import fftconvolve

    h = gaussian_kernel()
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y = fftconvolve(x_true, h, mode="same").astype(np.float32)
    y += 0.01 * rng.standard_normal(shape).astype(np.float32)
    return h, x_true, y


def blocks_image(rng, shape=SHAPE, block=64):
    """A piecewise-constant image (64-pixel blocks of |N(0, 1)| levels), the
    kind of image a TV prior recovers."""
    levels = np.abs(rng.standard_normal((shape[0] // block, shape[1] // block)))
    return np.kron(levels, np.ones((block, block))).astype(np.float32)


def keep_mask(shape=SHAPE):
    """The benchmark's sampling mask (bench.py sec_inpaint): 70% kept."""
    return np.random.default_rng(13).random(shape) < 0.7


def blocks_problem(rng, h, shape=SHAPE, block=64):
    """The same blur and noise on the piecewise-constant image of
    :func:`blocks_image`.  White noise is no such image: there the TV
    solution's error stays about 0.5% above the observation's, to
    convergence."""
    from scipy.signal import fftconvolve

    x_true = blocks_image(rng, shape, block)
    y = fftconvolve(x_true, h, mode="same").astype(np.float32)
    y += 0.01 * rng.standard_normal(shape).astype(np.float32)
    return x_true, y


def median_ms(fn, reps=15, warmup=3):
    """Median CUDA-event time of one call of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(got, want):
    """(max abs error, max abs error / max(1, max |want|))."""
    a = float((got - want).abs().max())
    return a, a / max(1.0, float(want.abs().max()))


def phase_kernels(dev, rng):
    from pycsou_tpu_torch.kernels.conv2d import (
        SepFactors, sepconv2d, sepconv2d_plain, sepgram2d, sepgram2d_plain,
    )
    from pycsou_tpu_torch.kernels.tv import (
        tv_pds_sweep_step_stats, tv_pds_sweep_step_stats_plain, tv_pds_sweepm2_step,
        tv_pds_sweepm2_step_plain, tv_pds_sweepm_step_stats, tv_pds_sweepm_step_stats_plain,
    )
    from pycsou_tpu_torch.kernels.tvr import (
        tv_pds_megar_step, tv_pds_megar_step_plain, tv_pds_megarm_step_plain,
    )
    from pycsou_tpu_torch.ops.conv import lowrank_factors

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(np.abs(rng.standard_normal(SHAPE)))
    atb = t(rng.standard_normal(SHAPE))
    z0 = t(0.01 * rng.standard_normal(SHAPE))
    z1 = t(0.01 * rng.standard_normal(SHAPE))
    m = t(keep_mask())
    matb = m * atb  # a back-projection vanishes where nothing was sampled
    kw = dict(tau=0.3, sigma=0.3, rho=0.9, lam=LAM, nonneg=True, iso=True)
    res = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS}

    def note(k, label, got, want, fn, plain_fn, psf):
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for i, (a, b) in enumerate(pairs):
            if b.ndim == 1:  # the metric partial sums
                rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                if rel > TOL_STATS:
                    raise AssertionError(f"{k} {label} stats rel err {rel:.3e} > {TOL_STATS}")
                continue
            ab, rel = max_err(a, b)
            res[k]["max_abs_err"] = max(res[k]["max_abs_err"], ab)
            res[k]["max_rel_err"] = max(res[k]["max_rel_err"], rel)
            if rel > TOL_REL:
                raise AssertionError(f"{k} {label} output {i}: err {ab:.3e} (rel {rel:.3e}) > {TOL_REL}")
        ms, pms = median_ms(fn), median_ms(plain_fn)
        log(f"  {k} {label:<12} {psf:<6} max abs err {res[k]['max_abs_err']:.3e} "
            f"(rel {res[k]['max_rel_err']:.3e}, tol {TOL_REL:g}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
        return ms, pms

    for psf, h in (("gauss", gaussian_kernel()), ("rank2", rank2_kernel())):
        us, vs = lowrank_factors(h)
        f = SepFactors(us, vs, h.shape[0] // 2, h.shape[1] // 2, dev)
        a, a2 = f.adjoint(), f.adjoint(2.0)
        log(f"PSF {psf}: rank {f.rank}, {f.Ku}x{f.Kv} taps")
        times = {}
        times["K1"] = note("K1", "forward", sepconv2d(x, f), sepconv2d_plain(x, f),
                           lambda: sepconv2d(x, f), lambda: sepconv2d_plain(x, f), psf)
        note("K1", "adjoint", sepconv2d(x, a), sepconv2d_plain(x, a),
             lambda: sepconv2d(x, a), lambda: sepconv2d_plain(x, a), psf)
        note("K2", "gram", sepgram2d(x, f, a), sepgram2d_plain(x, f, a),
             lambda: sepgram2d(x, f, a), lambda: sepgram2d_plain(x, f, a), psf)
        times["K2"] = note("K2", "gradient", sepgram2d(x, f, a2, atb), sepgram2d_plain(x, f, a2, atb),
                           lambda: sepgram2d(x, f, a2, atb), lambda: sepgram2d_plain(x, f, a2, atb), psf)
        g = sepgram2d_plain(x, f, a2, atb)
        times["K3"] = note("K3", "step", tv_pds_sweep_step_stats(x, z0, z1, g, **kw),
                           tv_pds_sweep_step_stats_plain(x, z0, z1, g, **kw),
                           lambda: tv_pds_sweep_step_stats(x, z0, z1, g, **kw),
                           lambda: tv_pds_sweep_step_stats_plain(x, z0, z1, g, **kw), psf)
        times["K4"] = note("K4", "step", tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw),
                           tv_pds_megar_step_plain(x, z0, z1, atb, f, a2, **kw),
                           lambda: tv_pds_megar_step(x, z0, z1, atb, f, a2, **kw),
                           lambda: tv_pds_megar_step_plain(x, z0, z1, atb, f, a2, **kw), psf)
        times["K7"] = note("K7", "step", tv_pds_megar_step(x, z0, z1, atb, f, a2, mask=m, **kw),
                           tv_pds_megarm_step_plain(x, z0, z1, m, atb, f, a2, **kw),
                           lambda: tv_pds_megar_step(x, z0, z1, atb, f, a2, mask=m, **kw),
                           lambda: tv_pds_megarm_step_plain(x, z0, z1, m, atb, f, a2, **kw), psf)
        for k, (ms, pms) in times.items():
            key = "" if psf == "gauss" else "rank2_"
            res[k][key + "ms"], res[k][key + "plain_ms"] = ms, pms
    # the masked steps take no PSF
    res["K5"]["ms"], res["K5"]["plain_ms"] = note(
        "K5", "step", tv_pds_sweepm_step_stats(x, z0, z1, m, matb, **kw),
        tv_pds_sweepm_step_stats_plain(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm_step_stats(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm_step_stats_plain(x, z0, z1, m, matb, **kw), "-")
    res["K6"]["ms"], res["K6"]["plain_ms"] = note(
        "K6", "2 steps", tv_pds_sweepm2_step(x, z0, z1, m, matb, **kw),
        tv_pds_sweepm2_step_plain(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm2_step(x, z0, z1, m, matb, **kw),
        lambda: tv_pds_sweepm2_step_plain(x, z0, z1, m, matb, **kw), "-")
    torch.cuda.synchronize()

    # the floors the stream-bound kernels are held to: a device-to-device
    # copy of 7 (K4) and 8 (K5, K6 for two iterations, K7) image streams'
    # worth, n x 64 MiB, which itself moves 2 x n x 64 MiB
    copy_ms = {}
    for streams in (7, 8):
        n = streams * SHAPE[0] * SHAPE[1]
        src = torch.empty(n, dtype=torch.float32, device=dev).uniform_()
        dst = torch.empty_like(src)
        copy_ms[streams] = median_ms(lambda: dst.copy_(src), reps=10)
        log(f"device-to-device copy of {streams} x 64 MiB: {copy_ms[streams]:.4f} ms "
            f"({2 * n * 4 / copy_ms[streams] / 1e6:.1f} GB/s read+write)")
        del src, dst
    log(f"gauss: K4 {res['K4']['ms']:.4f} ms, K7 {res['K7']['ms']:.4f} ms; K5 {res['K5']['ms']:.4f} ms, "
        f"K6 {res['K6']['ms']:.4f} ms for two iterations")
    return res, copy_ms


def count_launches(counters, fn):
    """``fn()`` with every launch counter set to 0 just before it; returns
    its result and the launches it made, per kernel."""
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in zip(KERNELS, counters)}


def expect_launches(name, counts, exact, at_most=None):
    """The kernels of ``exact`` launched exactly so often, those of
    ``at_most`` no more often, every other kernel never."""
    at_most = at_most or {}
    for k, v in counts.items():
        if k in exact:
            ok, want = v == exact[k], exact[k]
        elif k in at_most:
            ok, want = v <= at_most[k], f"<= {at_most[k]}"
        else:
            ok, want = v == 0, 0
        if not ok:
            raise AssertionError(f"{name}: {k} launched {v} times, expected {want}")


def built_and_run(build, n=ITERS):
    """A run that builds a solver through its entry point and runs it for
    ``n`` iterations: ``(solver, state)``."""
    def run():
        solver = build()
        return solver, solver.run_fixed(n)
    return run


def recovery(state, x_true, observed):
    """(||x - x_true||, ||observed - x_true||); x must be a finite image of
    the full shape."""
    x = state["x"]
    if tuple(x.shape) != SHAPE or not bool(torch.isfinite(x).all()):
        raise AssertionError("x is not a finite 4096 x 4096 image")
    return float(torch.linalg.vector_norm(x - x_true)), float(torch.linalg.vector_norm(observed - x_true))


def cross_check(name, counters, fn, ref, exact, at_most=None):
    """``fn()`` counted on its own, held to ``ref`` within TOL_PATH."""
    o, counts = count_launches(counters, fn)
    log(f"{name}: run for {o['it']} iterations; launches {counts}")
    expect_launches(name, counts, exact, at_most)
    z = o["z"] if "z" in o else torch.stack([o["z0"], o["z1"]])
    zr = ref["z"] if "z" in ref else torch.stack([ref["z0"], ref["z1"]])
    ex, _ = max_err(o["x"], ref["x"])
    ez, _ = max_err(z, zr)
    scale = max(1.0, float(ref["x"].abs().max()))
    log(f"{name} after {o['it']} iterations: max |dx| {ex:.3e}, max |dz| {ez:.3e} (tol {TOL_PATH:g} x {scale:.3f})")
    if ex > TOL_PATH * scale or ez > TOL_PATH * scale:
        raise AssertionError(f"{name} disagrees with the fused engine")
    return counts


def phase_main_path(dev, rng, counters):
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D, Gradient
    from pycsou_tpu_torch.opt import PDS, TVDeconvolution

    h, x_true, y = make_problem(rng)
    yt = torch.from_numpy(y).to(dev)

    def expression(data, **kw):
        return PDS(
            SHAPE, F=SquaredL2Loss(SHAPE, data=data) * Convolve2D(SHAPE, h, device=dev),
            G=NonNegativeOrthant(SHAPE), H=LAM * L21Norm((2,) + SHAPE, axis=0),
            K=Gradient(SHAPE), **kw,
        )

    def errors(state, x_true, data):
        return recovery(state, torch.from_numpy(x_true).to(dev), data)

    # the main path: the README expression built and run, nothing else; K1
    # twice for A^H y (LeastSquaresLoss and TVDeconvolution each form it,
    # as in the reference)
    (pds, st), main = count_launches(counters, built_and_run(lambda: expression(yt, max_iter=3000)))
    fused = pds._fused
    if type(fused) is not TVDeconvolution or fused.stencil_mode != "megar":
        raise AssertionError(f"PDS fused onto {type(fused).__name__}[{getattr(fused, 'stencil_mode', None)}]")
    log(f"main path: PDS built and run for {st['it']} iterations; launches {main}")
    expect_launches("main path", main, {"K1": 2, "K4": ITERS})
    err, obs = errors(st, x_true, yt)
    log(f"PDS -> {type(fused).__name__}[{fused.stencil_mode}] tau=sigma={pds.tau:.6f} rho={pds.rho}; "
        f"benchmark problem after {st['it']} iterations: ||x - x_true|| / ||y - x_true|| = {err / obs:.6f}")

    xb_true, yb = blocks_problem(rng, h)
    ybt = torch.from_numpy(yb).to(dev)
    sb = expression(ybt, max_iter=3000).run_fixed(ITERS)
    err, obs = errors(sb, xb_true, ybt)
    log(f"piecewise-constant image after {sb['it']} iterations: ||x - x_true|| = {err:.4f} "
        f"< ||y - x_true|| = {obs:.4f}: {err < obs}")
    if not err < obs:
        raise AssertionError("the recovery is no better than the blurred observation")

    # the same iterations by the other entry points on the card, each
    # counted on its own against megar: the generic chain (fuse=False: the
    # K2 gradient and plain operators) and the sweep engine (K2 + K3); K1
    # forms A^H y
    n = 5
    ref = pds.run_fixed(n)
    runs = {"main path": main}
    runs["PDS fuse=False"] = cross_check(
        "PDS fuse=False", counters, lambda: expression(yt, max_iter=3000, fuse=False).run_fixed(n),
        ref, {"K2": n}, {"K1": 2})
    runs["TVDeconvolution stencil='sweep'"] = cross_check(
        "TVDeconvolution stencil='sweep'", counters,
        lambda: TVDeconvolution(SHAPE, yt, LAM, filt=h, stencil="sweep", max_iter=3000).run_fixed(n),
        ref, {"K2": n, "K3": n}, {"K1": 2})
    return pds, runs


def phase_masked_paths(dev, rng, counters):
    """The masked paths at full size, each built through its entry point
    and run with the launch counters zeroed just before and read just
    after, on the piecewise-constant image."""
    from pycsou_tpu_torch.func import L21Norm, NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu_torch.ops import Convolve2D, DownSampling, Gradient, Masking
    from pycsou_tpu_torch.opt import CPS, PDS, TVDeconvolution

    h = gaussian_kernel()
    xt = torch.from_numpy(blocks_image(rng)).to(dev)

    def noise(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def tv():
        return LAM * L21Norm((2,) + SHAPE, axis=0)

    def pds(op, y, **kw):
        return PDS(SHAPE, F=SquaredL2Loss(op.codim_shape, data=y) * op, G=NonNegativeOrthant(SHAPE),
                   H=tv(), K=Gradient(SHAPE), max_iter=3000, **kw)

    M = Masking(SHAPE, keep_mask(), device=dev)
    D = DownSampling(SHAPE, 2)
    MA = M * Convolve2D(SHAPE, h, device=dev)
    y_in = M(xt) + noise(M.codim_shape, 0.01)
    y_ds = D(xt) + noise(D.codim_shape, 0.01)
    y_bl = MA(xt) + noise(M.codim_shape, 0.01)
    y_dn = xt + noise(SHAPE, 0.1)
    # name -> (entry point, engine, exact launches, launch bounds, the
    # observation the recovery must beat: the zero-filled back-projection,
    # or the noisy image)
    paths = {
        "inpainting": (lambda: pds(M, y_in), "sweepm2", {"K6": ITERS // 2}, {}, M.adjoint(y_in)),
        "zero-fill super-resolution": (lambda: pds(D, y_ds), "sweepm2", {"K6": ITERS // 2}, {},
                                       D.adjoint(y_ds)),
        "blurred super-resolution": (lambda: pds(MA, y_bl), "megarm", {"K7": ITERS}, {"K1": 2},
                                     M.adjoint(y_bl)),
        "denoising": (lambda: PDS(SHAPE, F=SquaredL2Loss(SHAPE, data=y_dn), G=NonNegativeOrthant(SHAPE),
                                  H=tv(), K=Gradient(SHAPE), max_iter=3000),
                      "sweepm2", {"K6": ITERS // 2}, {}, y_dn),
        "CPS denoising": (lambda: CPS(SHAPE, G=SquaredL2Loss(SHAPE, data=y_dn), H=tv(), K=Gradient(SHAPE),
                                      max_iter=3000),
                          "sweepm2", {"K6": ITERS // 2}, {}, y_dn),
    }
    runs, solvers = {}, {}
    for name, (build, engine, exact, at_most, observed) in paths.items():
        (solver, st), counts = count_launches(counters, built_and_run(build))
        fused = solver._fused
        if type(fused) is not TVDeconvolution or fused.stencil_mode != engine:
            raise AssertionError(
                f"{name}: fused onto {type(fused).__name__}[{getattr(fused, 'stencil_mode', None)}], "
                f"expected TVDeconvolution[{engine}]")
        log(f"{name}: {type(solver).__name__} -> TVDeconvolution[{engine}] ({fused.mode} mode) built "
            f"and run for {st['it']} iterations; launches {counts}")
        if st["it"] != ITERS:
            raise AssertionError(f"{name}: ran {st['it']} iterations, expected {ITERS}")
        expect_launches(name, counts, exact, at_most)
        err, obs = recovery(st, xt, observed)
        log(f"{name}: ||x - x_true|| = {err:.4f} < ||observation - x_true|| = {obs:.4f}: {err < obs} "
            f"(ratio {err / obs:.6f})")
        if not err < obs:
            raise AssertionError(f"{name}: the recovery is no better than the observation")
        runs[name], solvers[name] = counts, solver

    # cross-checks after an even number of iterations, each counted on its
    # own: sweepm2 against sweepm (K5) and the generic chain, megarm against
    # the generic chain (K1 forms A^H and A on it)
    n = 6
    inp = solvers["inpainting"]
    ref = inp.run_fixed(n)
    name = "TVDeconvolution stencil='sweepm'"
    runs[name] = cross_check(
        name, counters,
        lambda: TVDeconvolution(SHAPE, inp._fused.y, LAM, mask=inp._fused.mask, tau=inp.tau,
                                sigma=inp.sigma, stencil="sweepm", max_iter=3000).run_fixed(n),
        ref, {"K5": n})
    cross_check("inpainting PDS fuse=False", counters, lambda: pds(M, y_in, fuse=False).run_fixed(n), ref, {})
    ref = solvers["blurred super-resolution"].run_fixed(n)
    cross_check("blurred super-resolution PDS fuse=False", counters,
                lambda: pds(MA, y_bl, fuse=False).run_fixed(n), ref, {}, {"K1": 2 * n + 2})
    return runs, solvers


def time_solver(solver, n_short=20, n_long=100, reps=3):
    """Slope-timed iterations/s (bench.py _time_solver): the difference of
    a long and a short run cancels the constant per-run cost."""
    state = solver.run_fixed(n_short)
    torch.cuda.synchronize()
    slopes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = solver.run_fixed(n_short, state=state)
        torch.cuda.synchronize()
        ts = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = solver.run_fixed(n_long, state=state)
        torch.cuda.synchronize()
        tl = time.perf_counter() - t0
        slopes.append((tl - ts) / (n_long - n_short))
    return 1.0 / statistics.median(slopes)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    from pycsou_tpu_torch.kernels import _build, conv2d, tv, tvr

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built/loaded from {_build.build_dir()} in {time.perf_counter() - t0:.2f} s")
    # in KERNELS order
    counters = [conv2d.sepconv2d, conv2d.sepgram2d, tv.tv_pds_sweep_step_stats, tvr.tv_pds_megar_step,
                tv.tv_pds_sweepm_step_stats, tv.tv_pds_sweepm2_step, tvr.tv_pds_megarm_step]

    rng = np.random.default_rng(SEED)
    log(f"-- kernels against their plain versions at {SHAPE[0]} x {SHAPE[1]}")
    res, copy_ms = phase_kernels(dev, rng)
    log("-- main path")
    pds, runs = phase_main_path(dev, rng, counters)
    log("-- masked paths")
    masked_runs, solvers = phase_masked_paths(dev, rng, counters)
    runs.update(masked_runs)

    log(f"-- throughput ({smi})")
    ips = {"main path": time_solver(pds)}
    for name in ("inpainting", "blurred super-resolution", "denoising"):
        ips[name] = time_solver(solvers[name])
    for name, v in ips.items():
        engine = (pds if name == "main path" else solvers[name])._fused.stencil_mode
        log(f"{name} PDS[{engine}] slope-timed: {v:.1f} iters/s ({1e3 / v:.4f} ms/iteration)")
    tol_solver = pds.replace(tol=1e-6, min_iter=50)
    tol_solver.run_fixed(5)  # warm
    torch.cuda.synchronize()
    info = tol_solver.solve()
    log(f"main path solve() to 1e-6: {info.elapsed:.3f} s, converged={info.converged} at iteration "
        f"{info.converged_at} ({info.n_iter} run)")
    if not info.converged or not math.isfinite(info.elapsed):
        raise AssertionError("solve() did not reach 1e-6")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def entry(k, run):
        name, source, replaces = KERNELS[k]
        r = res[k]
        out = {
            "name": f"{k} {name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[run][k], "run": run,
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        }
        if "rank2_ms" in r:
            out["rank2_ms"], out["rank2_plain_ms"] = r["rank2_ms"], r["rank2_plain_ms"]
        return out

    # "kernels": the main paths' kernels, each with the launches of the run
    # of its path; K2, K3 and K5, which no fused main path runs, with the
    # launches of the run that goes through them
    print(json.dumps({
        "kernels": [entry(k, run) for k, run in MAIN_PATH_KERNELS.items()],
        "off_main_path_kernels": [entry(k, run) for k, run in OFF_MAIN_PATH_KERNELS.items()],
        "copy_ms": {f"{n}x64MiB": v for n, v in copy_ms.items()}, "iters_per_s": ips,
        "time_to_1e6_s": info.elapsed, "card": smi,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
