"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from conftest import BENCH_DIR, ROOT, load_tiny, run_tiny, write_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]+$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH_CHARS.match(p) and len(p) <= 200 and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    cells, rs = 24, BENCH["run_seconds"]
    runs = 2 + 14 * cells
    assert runs * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert set(cfg["limits"]) == {"x_rel_l2", "x_rel_max", "stop_gap"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_report_what_the_contract_asks(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    assert (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (BENCH_DIR / "reference" / f"{cell['config']}.py").is_file()
    c = load_tiny(ROOT / "BENCHMARK.json", cell["name"])
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_names_units_and_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entries_have_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric.get("workloads", ())) <= set(moved.get("workloads", cells))
    assert callable(getattr(load_tiny(ROOT / "BENCHMARK.json", BENCH["workloads"][0]["name"])
                            .reader(metric["name"]), "read"))


def test_split_names_are_read_by_their_quantity():
    """``<quantity>.<split>`` without a file of its own is read by
    ``metrics/<quantity>.py``; each cell reports one rate, and the metrics
    of its layers move that rate."""
    cell = load_tiny(ROOT / "BENCHMARK.json", "deconv.frames2048")
    assert cell.reader("iters_per_image.host_paced") is cell.reader("iters_per_image")
    assert not (BENCH_DIR / "metrics" / "iters_per_image.host_paced.py").exists()
    for w in BENCH["workloads"]:
        c = load_tiny(ROOT / "BENCHMARK.json", w["name"])
        rates = [m["name"] for m in c.end_to_end if m["name"].startswith("images_per_s.")]
        assert len(rates) == 1
        assert {m["moves"] for m in c.per_layer} == set(rates)


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert PATH_CHARS.match(str(p.relative_to(ROOT))), p


def test_a_new_traffic_file_runs_without_editing_any_file(tmp_path):
    """Only files are added (a mix, a cell in a copy of BENCHMARK.json):
    the harness finds them by name and runs the cell."""
    before = {p: p.read_bytes() for p in BENCH_DIR.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    bench_json = write_copy(tmp_path)
    result = run_tiny(bench_json, "inpaint.tiny")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"images_per_s.device_paced", "setup_s"}
    copy = bench_json.parent / "perfbench"
    for p, data in before.items():
        twin = copy / p.relative_to(BENCH_DIR)
        if "tests" not in p.relative_to(BENCH_DIR).parts:
            assert twin.read_bytes() == data
