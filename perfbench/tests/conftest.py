"""Fixtures of the benchmark's CPU tests: a copy of ``perfbench/`` with a
tiny traffic mix and a ``BENCHMARK.json`` that names cells over it, so that
a whole run goes through on the CPU in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"image": [48, 64], "pool": 2, "upload": False, "build": "setup", "tol": 1e-6,
        "min_iter": 50, "max_iter": 400, "check_jobs": 2}
TINY_FRAMES = dict(TINY, pool=3, upload=True, build="job")
# a tiny cell: (config, traffic, the cell whose metrics it reports)
TINY_CELLS = {"deconv.tiny": ("tvdeconv-gauss15", "tiny", "deconv.tol4096"),
              "inpaint.tiny": ("tvinpaint-keep70", "tiny", "deconv.tol4096"),
              "deconv.tinyframes": ("tvdeconv-gauss15", "tinyframes", "deconv.frames2048")}


def write_copy(tmp: Path) -> Path:
    """A copy of ``perfbench/`` under ``tmp`` with the tiny mixes added as
    new files, and a ``BENCHMARK.json`` with the tiny cells beside the
    repository's; returns the copy's ``BENCHMARK.json``."""
    dst = tmp / "perfbench"
    shutil.copytree(BENCH_DIR, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    (dst / "traffic" / "tinyframes.json").write_text(json.dumps(TINY_FRAMES))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (config, traffic, like) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                   "why": "a CPU test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    return write_copy(tmp)


def load_tiny(bench_json: Path, name: str):
    from perfbench.harness import spec

    return spec.load_cell(name, benchmark=bench_json, bench_dir=bench_json.parent / "perfbench")


def run_tiny(bench_json: Path, name: str, trace: bool = False, seed: int = 2**33 + 7, seconds: float = 0.3):
    import time

    from perfbench.harness.main import run_cell

    return run_cell(load_tiny(bench_json, name), seed, seconds, trace, "cpu", time.perf_counter())
