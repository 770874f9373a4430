"""The readers of the program's own spans and counters
(``harness/program.py``): their values on a synthetic trace and hand-made
records, nothing to read from a program without records or in an untraced
run, and the entries of ``BENCHMARK.json`` that they read."""
from __future__ import annotations

import json
import math
import sys
import types
from collections import namedtuple

import pytest

from conftest import ROOT, load_tiny, run_tiny
from perfbench.harness import program
from perfbench.harness.jobs import JobRecord, Window
from perfbench.harness.main import Context
from perfbench.harness.trace import Trace
from pycsou_tpu_torch.utils import profiling

Span = namedtuple("Span", "name start_ns end_ns parent request")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"enqueue_us_per_iter.device_paced", "enqueue_us_per_iter.host_paced",
       "host_reads_per_solve.device_paced", "host_reads_per_solve.host_paced",
       "read_idle_ms_per_solve.device_paced", "read_idle_ms_per_solve.host_paced",
       "edge_idle_ms_per_solve.device_paced", "edge_idle_ms_per_solve.host_paced",
       "lipschitz_ms", "match_ms"}


def _records():
    """Two jobs in a window 0-2000: a build (``pds.init`` 0-100 holding
    ``pds.match`` 10-90 holding ``conv.lipschitz`` 20-60) and a solve of
    two chunks, then a solve of one chunk with no build."""
    r = [("pds.init", 0, 100, None, 0), ("pds.match", 10, 90, 0, 0), ("conv.lipschitz", 20, 60, 1, 0),
         ("solve", 100, 600, None, 3), ("solve.start", 100, 150, 3, 3), ("solve.enqueue", 150, 300, 3, 3),
         ("solve.read", 300, 350, 3, 3), ("solve.enqueue", 350, 500, 3, 3), ("solve.read", 500, 520, 3, 3),
         ("solve.finish", 520, 600, 3, 3),
         ("solve", 1000, 1300, None, 10), ("solve.start", 1000, 1040, 10, 10),
         ("solve.enqueue", 1040, 1200, 10, 10), ("solve.read", 1200, 1260, 10, 10),
         ("solve.finish", 1260, 1300, 10, 10),
         ("solve", 2500, 2600, None, 15)]  # after the window: another run's
    return [Span(*t) for t in r]


def _trace():
    # busy: 0-5 (build), 160-310 (chunk 1; the read's turnaround gap 310-360
    # ends in the next enqueue), 360-505, 1050-1210, 1700-1800
    ops = [(0, 5, "k1", "kernel"), (160, 310, "k10", "kernel"), (360, 505, "k10", "kernel"),
           (1050, 1210, "k10", "kernel"), (1700, 1800, "copy", "gpu_memcpy")]
    return Trace(window=(0, 2000), spans={"window": [(0, 2000)]}, ops=ops)


def _fake_program(records, counters):
    mod = types.ModuleType(program.MODULE)
    kept = {"records": list(records), "counters": dict(counters)}
    mod.records = lambda: list(kept["records"])
    mod.counters = lambda: dict(kept["counters"])
    mod.reset = lambda: (kept["records"].clear(), kept["counters"].clear())
    return mod, kept


@pytest.fixture
def ctx_of(monkeypatch):
    monkeypatch.setattr(program, "_taken", [])

    def make(cell_name, trace, module):
        """``module`` stands for the program's profiling module (None: not
        loaded)."""
        if module is None:
            monkeypatch.delitem(sys.modules, program.MODULE, raising=False)
        else:
            monkeypatch.setitem(sys.modules, program.MODULE, module)
        cell = load_tiny(ROOT / "BENCHMARK.json", cell_name)
        jobs = [JobRecord(0, 0, 0.05, n_iter=32), JobRecord(1, 1, 0.04, n_iter=16)]
        win = Window(jobs=jobs, window_s=2e-6, sampled=[])
        ctx = Context(cell=cell, setup_s=1.0, window=win, trace=trace, peaks=None, counts=cell.config_module())
        return cell, ctx
    return make


def test_readers_on_a_synthetic_trace_and_records(ctx_of):
    mod, kept = _fake_program(_records(), {"solve.host_reads": 7})
    cell, ctx = ctx_of("deconv.frames2048", _trace(), mod)
    read = lambda name: cell.reader(name).read(ctx)  # noqa: E731
    # enqueue: 150 + 150 + 160 ns over 48 iterations
    assert read("enqueue_us_per_iter.host_paced") == pytest.approx(460 / 1e3 / 48)
    assert read("host_reads_per_solve.host_paced") == pytest.approx(7 / 2)
    # gaps: 5-160 starts in pds.init (before pds.match opens), 310-360 in
    # solve.read (it ends in solve.enqueue), 505-1050 and 1210-1700 in
    # solve.read, 1800-2000 outside every span
    idle = program.read(ctx).idle_ns_by_span(ctx.trace)
    assert idle == {"pds.init": 155, "solve.read": 50 + 545 + 490, "none": 200}
    assert read("read_idle_ms_per_solve.host_paced") == pytest.approx((50 + 545 + 490) / 1e6 / 2)
    assert read("edge_idle_ms_per_solve.host_paced") == 0
    assert read("lipschitz_ms") == pytest.approx(40 / 1e6)
    assert read("match_ms") == pytest.approx(80 / 1e6)
    # the first read took the program's records and cleared them; the
    # window's later readers read what was taken
    assert kept == {"records": [], "counters": {}}
    assert read("host_reads_per_solve.host_paced") == pytest.approx(7 / 2)


def test_gaps_are_put_down_to_the_span_open_where_they_start(ctx_of):
    recs = [Span("solve", 0, 1000, None, 0), Span("solve.start", 0, 100, 0, 0),
            Span("solve.enqueue", 100, 400, 0, 0), Span("solve.read", 400, 450, 0, 0),
            Span("solve.enqueue", 450, 800, 0, 0), Span("solve.read", 800, 820, 0, 0),
            Span("solve.finish", 820, 1000, 0, 0)]
    ops = [(50, 60, "fill", "gpu_memset"), (120, 390, "k10", "kernel"), (395, 420, "d2h", "gpu_memcpy"),
           (430, 500, "k10", "kernel"), (700, 810, "k10", "kernel"), (900, 910, "d2h", "gpu_memcpy")]
    mod, _ = _fake_program(recs, {"solve.host_reads": 4})
    cell, ctx = ctx_of("deconv.tol4096", Trace(window=(0, 1000), spans={"window": [(0, 1000)]}, ops=ops), mod)
    idle = program.read(ctx).idle_ns_by_span(ctx.trace)
    # 0-50 and 60-120 start in solve.start; 390-395 in solve.enqueue;
    # 420-430 in solve.read; 500-700 in solve.enqueue; 810-900 in
    # solve.read (ends in the finish); 910-1000 in solve.finish
    assert idle == {"solve.start": 50 + 60, "solve.enqueue": 5 + 200, "solve.read": 10 + 90,
                    "solve.finish": 90}
    assert sum(idle.values()) == 1000 - ctx.trace.busy_s() * 1e9
    assert cell.reader("read_idle_ms_per_solve.device_paced").read(ctx) == pytest.approx(100 / 1e6)
    assert cell.reader("edge_idle_ms_per_solve.device_paced").read(ctx) == pytest.approx(200 / 1e6)
    assert cell.reader("host_reads_per_solve.device_paced").read(ctx) == 4


@pytest.mark.parametrize("case", ["untraced", "no module", "no record API", "no solve", "no device ops"])
def test_nothing_to_read(ctx_of, case):
    trace = None if case == "untraced" else _trace()
    if case == "no module":
        mod = None
    elif case == "no record API":
        mod = types.ModuleType(program.MODULE)  # an older program's profiling module
        mod.annotate = lambda name: None
    else:
        recs = [r for r in _records() if case != "no solve" or not r.name.startswith("solve")]
        mod, _ = _fake_program(recs, {"solve.host_reads": 7} if case != "no solve" else {})
    if case == "no device ops":
        trace = Trace(window=(0, 2000), spans={"window": [(0, 2000)]}, ops=[])
    cell, ctx = ctx_of("deconv.frames2048", trace, mod)
    values = {m["name"]: cell.reader(m["name"]).read(ctx) for m in cell.per_layer if m["name"] in NEW}
    assert set(values) == NEW - {n for n in NEW if n.endswith(".device_paced")}
    if case in ("untraced", "no module", "no record API"):
        assert all(v is None for v in values.values()), values
    elif case == "no solve":
        assert values["lipschitz_ms"] == pytest.approx(40 / 1e6)
        assert all(values[n] is None for n in values if n not in ("lipschitz_ms", "match_ms")), values
    else:
        assert values["read_idle_ms_per_solve.host_paced"] is None
        assert values["edge_idle_ms_per_solve.host_paced"] is None
        assert values["host_reads_per_solve.host_paced"] == pytest.approx(7 / 2)


def test_new_entries_have_readers_and_are_listed_where_they_read():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert set(entries) == NEW
    cells = {w["name"] for w in BENCH["workloads"]}
    for name, m in entries.items():
        assert callable(load_tiny(ROOT / "BENCHMARK.json", "deconv.tol4096").reader(name).read)
        paced = "device_paced" if name.endswith(".device_paced") else "host_paced"
        assert m["moves"] == f"images_per_s.{paced}"
        want = {"deconv.tol4096"} if paced == "device_paced" else {"deconv.frames2048"}
        assert set(m["workloads"]) == want
        for cell in cells:
            listed = name in {e["name"] for e in load_tiny(ROOT / "BENCHMARK.json", cell).per_layer}
            assert listed == (cell in want), (name, cell)
    assert BENCH["per_layer"][-len(NEW):] == list(entries.values())  # appended at the end


def test_a_traced_tiny_run_reads_the_program(tiny_bench):
    profiling.reset()
    result = run_tiny(tiny_bench, "deconv.tinyframes", trace=True)
    m, jobs = result["metrics"], result["jobs_summary"]
    assert result["correct"] is True
    for name in ("enqueue_us_per_iter.host_paced", "host_reads_per_solve.host_paced", "lipschitz_ms", "match_ms"):
        assert m[name]["value"] > 0, name
    lo, hi = (math.ceil(jobs[k] / 16) + 2 for k in ("n_iter_min", "n_iter_max"))
    assert lo <= m["host_reads_per_solve.host_paced"]["value"] <= hi
    # no device operations on the CPU: the idle readers read nothing
    assert not {"read_idle_ms_per_solve.host_paced", "edge_idle_ms_per_solve.host_paced"} & set(m)


def test_a_program_without_records_leaves_the_metrics_out(tiny_bench, monkeypatch):
    older = types.ModuleType(program.MODULE)
    monkeypatch.setitem(sys.modules, program.MODULE, older)
    try:
        result = run_tiny(tiny_bench, "deconv.tiny", trace=True)
    finally:
        profiling.reset()  # what the port kept, which nothing took
    assert result["correct"] is True
    assert "iters_per_image.device_paced" in result["metrics"]
    assert not NEW & set(result["metrics"])
