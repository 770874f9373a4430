"""The four-card cell's files on the CPU: ``tvdeconv-gauss15-rows4`` (its
configuration, its blocked reference, the traffic ``tol49152``) and the
readers ``halo_ms_per_iter`` and ``shard_kernel_roofline``.

* The readers on synthetic traces: what they count, what they leave out,
  and None where there is nothing to read.
* A tiny run of the configuration through ``run_cell`` on four CPU
  positions (the routed chain) against the blocked reference:
  ``correct: true``.
* ``instrument`` refuses, at once, a program without the norm bound that
  is free of the image's size."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from perfbench.harness import program, spec
from perfbench.harness.jobs import JobRecord, Window
from perfbench.harness.main import Context, run_cell
from perfbench.harness.peaks import PEAKS
from perfbench.harness.trace import Trace
from perfbench.tests.conftest import TINY, load_tiny

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def _span(name, s, e, request):
    return SimpleNamespace(name=name, start_ns=s, end_ns=e, parent=None, request=request)


def _ctx(cell, ops, spans, n_iter=(10,), peaks=H100):
    tr = Trace(window=(0, 10_000), spans={"window": [(0, 10_000)]}, ops=sorted(ops))
    program._taken[:] = [tr, program.Program(spans=spans, counters={})]
    window = Window(jobs=[JobRecord(i, 0, 1.0, n) for i, n in enumerate(n_iter)], window_s=1.0, sampled=[])
    return Context(cell=cell, setup_s=1.0, window=window, trace=tr, peaks=peaks, counts=cell.config_module())


@pytest.fixture(scope="module")
def cell():
    return spec.load_cell("deconv.sharded4")


def test_halo_reader_counts_peer_copies_inside_the_steps(cell):
    reader = cell.reader("halo_ms_per_iter")
    spans = [_span("solve", 100, 9000, 0), _span("solve.enqueue", 200, 300, 0), _span("solve.read", 300, 5000, 0),
             _span("sp.halo", 210, 220, 0), _span("solve.finish", 5000, 9000, 0)]
    ops = [(250, 1250, "Memcpy PtoP (Device -> Device)", "gpu_memcpy"),    # a halo, inside the steps
           (4000, 4500, "Memcpy PtoP (Device -> Device)", "gpu_memcpy"),   # another
           (3000, 3400, "void tv_mega2_shard_kernel<16>(...)", "kernel"),  # not a copy
           (3500, 3600, "Memcpy DtoD (Device -> Device)", "gpu_memcpy"),   # on one card
           (6000, 8000, "Memcpy PtoP (Device -> Device)", "gpu_memcpy")]   # the join, after the last read
    assert reader.read(_ctx(cell, ops, spans, n_iter=(5,))) == pytest.approx((1000 + 500) / 1e6 / 5)
    # a program without the sharded step's spans: nothing to read
    assert reader.read(_ctx(cell, ops, [s for s in spans if s.name != "sp.halo"])) is None


def test_shard_roofline_reader(cell):
    reader = cell.reader("shard_kernel_roofline")
    counts = cell.config_module()
    cfg, shape = cell.config, cell.shape
    least = max(counts.shard_bytes_per_launch(cfg, shape) / H100["hbm_byte_per_s"],
                counts.shard_flops_per_launch(cfg, shape) / H100["f32_flop_per_s"])
    assert least == pytest.approx(28 * 12288 * 49152 / 3.35e12)  # bound by the bytes: 5.04 ms
    dur = int(2 * least * 1e9)  # each launch at half its roofline
    ops = [(k * dur, (k + 1) * dur, "void pct::tv_mega2_shard_kernel<16>(float const*)", "kernel") for k in range(8)]
    ops.append((9 * dur, 10 * dur, "void stats_fold(float const*, int, float*)", "kernel"))
    assert reader.read(_ctx(cell, ops, [])) == pytest.approx(50.0, rel=1e-6)
    assert reader.read(_ctx(cell, ops[-1:], [])) is None
    assert reader.read(_ctx(cell, ops, [], peaks=None)) is None


def test_cell_entries(cell):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == "deconv.sharded4")
    assert w["chips"] == 4 and cell.shape == (49152, 49152) and cell.config["mesh"] == {"shape": [4], "axis": "sp"}
    names = {m["name"] for m in cell.per_layer}
    assert {"halo_ms_per_iter", "shard_kernel_roofline", "step_roofline.device_paced",
            "device_idle_pct.device_paced", "iters_per_image.device_paced"} <= names
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s.device_paced", "setup_s"]


def _tiny4(tiny_bench):
    """The tiny copy of ``perfbench/`` with a 128 x 96 mix and a cell of the
    configuration over it (four shards of 32 rows), in a ``BENCHMARK.json``
    of its own beside the copy."""
    root = tiny_bench.parent
    (root / "perfbench" / "traffic" / "tiny4.json").write_text(
        json.dumps(dict(TINY, image=[128, 96], pool=1, check_jobs=1)))
    bench = json.loads(tiny_bench.read_text())
    bench["workloads"].append({"name": "deconv.tiny4", "config": "tvdeconv-gauss15-rows4", "traffic": "tiny4",
                               "chips": 1, "why": "a CPU test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deconv.sharded4" in m.get("workloads", ()):
            m["workloads"].append("deconv.tiny4")
    path = root / "BENCHMARK-tiny4.json"
    path.write_text(json.dumps(bench))
    return load_tiny(path, "deconv.tiny4")


def test_a_tiny_run_on_four_cpu_positions_is_correct(tiny_bench):
    cell = _tiny4(tiny_bench)
    result = run_cell(cell, 2**33 + 26, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["solver"] == "PrimalDualSplitting -> DistributedTVDeconv2D[]"  # the chain on CPU devices
    assert set(result["metrics"]) == {"images_per_s.device_paced", "setup_s"}


def test_instrument_refuses_a_program_without_the_bound(cell, monkeypatch):
    from pycsou_tpu_torch.ops import conv

    mod = cell.config_module()
    monkeypatch.delattr(conv, "fft_norm_bound")
    t0 = time.perf_counter()
    with pytest.raises(mod.NoImageFreeNormBound, match="fft_norm_bound"):
        mod.instrument(cell.config, cell.shape, mod.shared_inputs(cell.config, cell.shape, 1, "cpu"), "cpu")
    assert time.perf_counter() - t0 < 1.0
