"""A cell of ``BENCHMARK.json`` and the files that belong to it, found by
name: ``configs/<config>.json`` (the configuration as it is run) and
``configs/<config>.py`` (its generator and the user-API builder of the
entry), ``traffic/<traffic>.json``, ``metrics/<metric>.py`` (one reader a
metric) and ``reference/<config>.py`` (the plain reference).  Adding a
cell, a mix or a metric adds files and entries; it edits none.

A quantity split by the end-to-end metric it belongs to is named
``<quantity>.<split>`` (``images_per_s.device_paced``,
``iters_per_image.host_paced``): without a ``metrics/<name>.py`` of its
own it is read by ``metrics/<quantity>.py``."""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = BENCH_DIR.parent  # the checkout


def load_module(path: Path, prefix: str):
    """The module at ``path`` (names such as ``tvdeconv-gauss15`` are not
    identifiers, so files are loaded by path), cached in ``sys.modules``."""
    path = Path(path).resolve()
    name = f"perfbench_{prefix}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    if name in sys.modules and Path(sys.modules[name].__file__).resolve() == path:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no {prefix} file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    bench_dir: Path
    end_to_end: list = field(default_factory=list)  # metric entries reported with --trace 0
    per_layer: list = field(default_factory=list)  # and with --trace 1

    @property
    def shape(self):
        return tuple(int(n) for n in self.traffic["image"])

    def config_module(self):
        return load_module(self.bench_dir / "configs" / f"{self.config_name}.py", "config")

    def reference_module(self):
        return load_module(self.bench_dir / "reference" / f"{self.config_name}.py", "reference")

    def reader(self, metric_name: str):
        path = self.bench_dir / "metrics" / f"{metric_name}.py"
        if not path.is_file():
            path = self.bench_dir / "metrics" / f"{metric_name.split('.')[0]}.py"
        return load_module(path, "metric")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = None, bench_dir: Path = None) -> Cell:
    """The cell ``name`` of ``benchmark`` (``BENCHMARK.json`` at the root of
    the checkout by default), its files under ``bench_dir``."""
    benchmark = Path(benchmark) if benchmark is not None else ROOT / "BENCHMARK.json"
    bench_dir = Path(bench_dir) if bench_dir is not None else BENCH_DIR
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}; it has {sorted(cells)}")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
                config=config, traffic=traffic, bench_dir=bench_dir, end_to_end=e2e, per_layer=per_layer)
