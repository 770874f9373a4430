#!/usr/bin/env python
"""Smoke test of pycsou_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and the time to build the CUDA kernels from
   ``pycsou_tpu_torch/csrc``.
2. Runs every kernel of the port (K1-K4) at 4096 x 4096 with the
   benchmark's 15 x 15 Gaussian PSF and its rank-2 PSF, against the plain
   PyTorch version on the same inputs: max abs / rel error against the
   stated tolerance, median CUDA-event times of kernel and plain.
3. Drives the main path through the user's entry point, the README's
   ``PDS`` expression at 4096 x 4096 on the benchmark's problem, with the
   launch counters zeroed just before it and read just after: it must
   fuse onto ``TVDeconvolution[megar]``, launch K1 for ``A^H y`` and K4
   once per iteration, and nothing else.  On a piecewise-constant image
   with the same blur and noise it must recover x better than the blurred
   observation.  The generic chain (``fuse=False``, K2) and the sweep
   engine (K2 + K3), each counted on its own, must agree with megar.
   Then the slope-timed iterations/s and the ``solve()`` time to a 1e-6
   relative improvement, on the benchmark's problem.

Any failure exits non-zero.  On success the last two lines are a JSON
object with the per-kernel results and the device line
``{"ok": true, "device": {...}}``.  In the results, ``kernels`` holds the
main path's kernels (K1, K4) with the launches of the main path's run;
``off_main_path_kernels`` holds K2 and K3 with the launches of the run
named in ``run``.  Without CUDA it exits 2 and prints no result.
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
}
# the fused main path (TVDeconvolution[megar]) runs K1 (A^H y) and K4; the
# other two run on the generic chain and the sweep engine
MAIN_PATH_KERNELS = ("K1", "K4")
OFF_MAIN_PATH_KERNELS = {"K2": "PDS fuse=False", "K3": "TVDeconvolution stencil='sweep'"}


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


def blocks_problem(rng, h, shape=SHAPE, block=64):
    """The same blur and noise on a piecewise-constant image (64-pixel
    blocks of |N(0, 1)| levels), the kind of image a TV prior recovers.
    White noise is not: there the TV solution's error stays about 0.5%
    above the observation's, to convergence."""
    from scipy.signal import fftconvolve

    levels = np.abs(rng.standard_normal((shape[0] // block, shape[1] // block)))
    x_true = np.kron(levels, np.ones((block, block))).astype(np.float32)
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
    from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_step_stats, tv_pds_sweep_step_stats_plain
    from pycsou_tpu_torch.kernels.tvr import tv_pds_megar_step, tv_pds_megar_step_plain
    from pycsou_tpu_torch.ops.conv import lowrank_factors

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(np.abs(rng.standard_normal(SHAPE)))
    atb = t(rng.standard_normal(SHAPE))
    z0 = t(0.01 * rng.standard_normal(SHAPE))
    z1 = t(0.01 * rng.standard_normal(SHAPE))
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
        for k, (ms, pms) in times.items():
            key = "" if psf == "gauss" else "rank2_"
            res[k][key + "ms"], res[k][key + "plain_ms"] = ms, pms
    torch.cuda.synchronize()

    # the floor K4 is held to: a device-to-device copy of its 7 image
    # streams' worth (7 x 64 MiB), which itself moves 2 x 448 MiB
    n = 7 * SHAPE[0] * SHAPE[1]
    src = torch.empty(n, dtype=torch.float32, device=dev).uniform_()
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src), reps=10)
    log(f"device-to-device copy of 7 x 64 MiB: {copy_ms:.4f} ms "
        f"({2 * n * 4 / copy_ms / 1e6:.1f} GB/s read+write); K4 gauss {res['K4']['ms']:.4f} ms")
    del src, dst
    return res, copy_ms


def count_launches(counters, fn):
    """``fn()`` with every launch counter set to 0 just before it; returns
    its result and the launches it made, per kernel."""
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in zip(KERNELS, counters)}


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
        xt = torch.from_numpy(x_true).to(dev)
        x = state["x"]
        if tuple(x.shape) != SHAPE or not bool(torch.isfinite(x).all()):
            raise AssertionError("x is not a finite 4096 x 4096 image")
        return float(torch.linalg.vector_norm(x - xt)), float(torch.linalg.vector_norm(data - xt))

    # the main path: the README expression built and run, nothing else
    def main_run():
        pds = expression(yt, max_iter=3000)
        return pds, pds.run_fixed(ITERS)

    (pds, st), main = count_launches(counters, main_run)
    fused = pds._fused
    if type(fused) is not TVDeconvolution or fused.stencil_mode != "megar":
        raise AssertionError(f"PDS fused onto {type(fused).__name__}[{getattr(fused, 'stencil_mode', None)}]")
    log(f"main path: PDS built and run for {st['it']} iterations; launches {main}")
    if main["K4"] != ITERS:
        raise AssertionError(f"K4 launched {main['K4']} times for {ITERS} iterations")
    if main["K1"] == 0:
        raise AssertionError("K1 (atb = A^H y) was not launched by the main path")
    if main["K2"] or main["K3"]:
        raise AssertionError("the fused main path launched K2/K3; megar runs K4 alone")
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
    # counted on its own: the generic chain (fuse=False: the K2 gradient and
    # plain operators) and the sweep engine (K2 + K3)
    n = 5
    ref = pds.run_fixed(n)
    others = {
        "PDS fuse=False": (lambda: expression(yt, max_iter=3000, fuse=False).run_fixed(n), {"K2": n}),
        "TVDeconvolution stencil='sweep'": (
            lambda: TVDeconvolution(SHAPE, yt, LAM, filt=h, stencil="sweep", max_iter=3000).run_fixed(n),
            {"K2": n, "K3": n},
        ),
    }
    runs = {"main path": main}
    zr = torch.stack([ref["z0"], ref["z1"]])
    for name, (fn, want) in others.items():
        o, counts = count_launches(counters, fn)
        runs[name] = counts
        log(f"{name}: run for {n} iterations; launches {counts}")
        for k, v in want.items():
            if counts[k] != v:
                raise AssertionError(f"{name}: {k} launched {counts[k]} times, expected {v}")
        if counts["K4"]:
            raise AssertionError(f"{name} launched K4")
        z = o["z"] if "z" in o else torch.stack([o["z0"], o["z1"]])
        ex, _ = max_err(o["x"], ref["x"])
        ez, _ = max_err(z, zr)
        scale = max(1.0, float(ref["x"].abs().max()))
        log(f"{name} vs megar after {n} iterations: max |dx| {ex:.3e}, max |dz| {ez:.3e} (tol {TOL_PATH:g} x {scale:.3f})")
        if ex > TOL_PATH * scale or ez > TOL_PATH * scale:
            raise AssertionError(f"{name} disagrees with megar")
    return pds, runs


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
    counters = [conv2d.sepconv2d, conv2d.sepgram2d, tv.tv_pds_sweep_step_stats, tvr.tv_pds_megar_step]

    rng = np.random.default_rng(SEED)
    log(f"-- kernels against their plain versions at {SHAPE[0]} x {SHAPE[1]}")
    res, copy_ms = phase_kernels(dev, rng)
    log("-- main path")
    pds, runs = phase_main_path(dev, rng, counters)

    log("-- throughput")
    ips = time_solver(pds)
    log(f"PDS[megar] slope-timed: {ips:.1f} iters/s ({1e3 / ips:.4f} ms/iteration)")
    tol_solver = pds.replace(tol=1e-6, min_iter=50)
    tol_solver.run_fixed(5)  # warm
    torch.cuda.synchronize()
    info = tol_solver.solve()
    log(f"solve() to 1e-6: {info.elapsed:.3f} s, converged={info.converged} at iteration "
        f"{info.converged_at} ({info.n_iter} run)")
    if not info.converged or not math.isfinite(info.elapsed):
        raise AssertionError("solve() did not reach 1e-6")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def entry(k, run):
        name, source, replaces = KERNELS[k]
        r = res[k]
        return {
            "name": f"{k} {name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[run][k], "run": run,
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "rank2_ms": r["rank2_ms"], "rank2_plain_ms": r["rank2_plain_ms"],
        }

    # "kernels": the main path's kernels, with the launches of the main
    # path's run; K2 and K3, which the fused main path does not run, with
    # the launches of the run that goes through them
    print(json.dumps({
        "kernels": [entry(k, "main path") for k in MAIN_PATH_KERNELS],
        "off_main_path_kernels": [entry(k, run) for k, run in OFF_MAIN_PATH_KERNELS.items()],
        "copy_7x64MiB_ms": copy_ms, "iters_per_s": ips, "time_to_1e6_s": info.elapsed, "card": smi,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
