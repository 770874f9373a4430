"""The roofline's counts and the trace reduction that the per-layer
readers read, on a synthetic trace."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import ROOT, load_tiny
from perfbench.harness.jobs import JobRecord, Window
from perfbench.harness.main import Context
from perfbench.harness.trace import Trace

N = 4096 * 4096


def test_deconvolution_counts_per_iteration_and_per_solve():
    cell = load_tiny(ROOT / "BENCHMARK.json", "deconv.tol4096")
    mod = cell.config_module()
    # the 29-tap symmetric autocorrelation a axis (43), the gradient (2),
    # the TV step (32), the stopping sums once in two iterations (7.5)
    assert mod.flops_per_iter(cell.config, (4096, 4096)) == (86 + 2 + 32 + 7.5) * N
    assert mod.bytes_per_solve(cell.config, (4096, 4096)) == 8 * N


def test_inpainting_counts_per_iteration_and_per_solve(tiny_bench):
    cell = load_tiny(tiny_bench, "inpaint.tiny")
    mod = cell.config_module()
    assert mod.flops_per_iter(cell.config, (4096, 4096)) == (3 + 32 + 7.5) * N
    assert mod.bytes_per_solve(cell.config, (4096, 4096)) == 9 * N


def _trace():
    # window 0-100; two jobs, each build 10-20 / 60-70 (host), solve 20-50 / 70-95
    spans = {"window": [(0, 100)], "build": [(10, 20), (60, 70)], "solve": [(20, 50), (70, 95)]}
    ops = [(12, 14, "k1", "kernel"), (22, 30, "k10", "kernel"), (30, 40, "k10", "kernel"),
           (35, 38, "copy", "gpu_memcpy"), (72, 90, "k10", "kernel"), (96, 99, "d2h", "gpu_memcpy")]
    return Trace(window=(0, 100), spans=spans, ops=ops)


def test_trace_busy_ops_and_breakdown():
    tr = _trace()
    assert tr.busy_s() == pytest.approx((2 + 18 + 18 + 3) / 1e9)
    assert [o[2] for o in tr.ops_in("solve", kinds=("kernel",))] == ["k10", "k10", "k10"]
    assert len(tr.ops_in("solve")) == 4
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k10", 36 / 1e9]
    assert b["idle_gaps"][0] == ["build", 32 / 1e9] or b["idle_gaps"][0][1] == 32 / 1e9
    labels = {label for label, _ in b["idle_gaps"]}
    assert labels <= {"build", "solve", "between jobs"}


def test_per_layer_readers_on_a_synthetic_trace():
    cell = load_tiny(ROOT / "BENCHMARK.json", "deconv.frames2048")
    jobs = [JobRecord(0, 0, 0.05, n_iter=4), JobRecord(1, 1, 0.04, n_iter=6)]
    win = Window(jobs=jobs, window_s=1e-7, sampled=[])
    peaks = {"f32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12}
    ctx = Context(cell=cell, setup_s=1.0, window=win, trace=_trace(), peaks=peaks, counts=cell.config_module())
    read = lambda name: cell.reader(name).read(ctx)  # noqa: E731
    assert read("build_ms") == pytest.approx(10 / 1e6)
    assert read("solve_iters_per_s") == pytest.approx(10 / (55 / 1e9))
    assert read("kernels_per_iter") == pytest.approx(3 / 10)
    assert read("device_ms_per_iter") == pytest.approx((8 + 10 + 3 + 18) / 1e6 / 10)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 41 / 100))
    flops = cell.config_module().flops_per_iter(cell.config, cell.shape)
    least = 10 * flops / 67e12
    assert read("step_roofline") == pytest.approx(100 * least / (39 / 1e9))
    assert read("iters_per_image") == 5


def test_readers_give_nothing_where_there_is_nothing_to_read():
    cell = load_tiny(ROOT / "BENCHMARK.json", "deconv.tol4096")
    win = Window(jobs=[JobRecord(0, 0, 0.05, n_iter=4)], window_s=0.05, sampled=[])
    empty = Trace(window=(0, 100), spans={"window": [(0, 100)]}, ops=[])
    for tr, peaks in ((None, None), (empty, None), (empty, {"f32_flop_per_s": 1, "hbm_byte_per_s": 1})):
        ctx = Context(cell=cell, setup_s=1.0, window=win, trace=tr, peaks=peaks, counts=cell.config_module())
        for name in ("build_ms", "kernels_per_iter", "device_ms_per_iter", "step_roofline", "device_idle_pct"):
            assert cell.reader(name).read(ctx) is None, name
    assert SimpleNamespace  # the module's helpers import
