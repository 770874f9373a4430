"""One run of one cell: set-up, a warm job, the measured window (traced
or not), the metrics, the check against the reference, the result line.

``run_cell`` takes the device it is given, so that a test can drive a
whole run on the CPU; ``cli`` is the benchmark's command, which refuses to
run without the card."""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from perfbench.harness import guard, spec
from perfbench.harness.check import check_jobs
from perfbench.harness.jobs import Setup, run_window, summary
from perfbench.harness.peaks import PEAKS


@dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py`` ``read(ctx)``)."""
    cell: object
    setup_s: float
    window: object  # jobs.Window
    trace: object  # trace.Trace, or None in an untraced run
    peaks: dict  # the card's peaks, or None
    counts: object  # the configuration's module: flops_per_iter, bytes_per_solve

    @property
    def jobs(self):
        return self.window.jobs

    @property
    def done(self):
        return [j for j in self.window.jobs if not j.failed]


def _device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """The result of one run (the dict printed as the last line)."""
    device = torch.device(device)
    phases = {"start": time.perf_counter() - t_start}
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    phases["device"] = time.perf_counter() - t_start
    setup = Setup(cell, seed, device)
    phases["inputs_and_builds"] = time.perf_counter() - t_start
    setup.release(setup.job(0)[2])  # the warm job: every kernel of the path built and loaded
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases["warm_job"] = setup_s
    check_n = int(cell.traffic.get("check_jobs", 1))
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from perfbench.harness.trace import reduce
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            setup.traced = True
            with record_function("perfbench.window"):
                window = run_window(setup, seconds, check_n, seed, first_index=1)
            setup.traced = False
            t_stop = time.perf_counter()
        print(f"trace: the profiler stopped in {time.perf_counter() - t_stop:.1f} s", file=sys.stderr)
        tr = reduce(prof)
        del prof
    else:
        window = run_window(setup, seconds, check_n, seed, first_index=1)
        tr = None
    dev_info = _device_info(device, cell.chips)
    setup.close()
    kind = dev_info["kind"]
    ctx = Context(cell=cell, setup_s=setup_s, window=window, trace=tr, peaks=PEAKS.get(kind),
                  counts=cell.config_module())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(j.failed for j in window.jobs)
    ok, checks = check_jobs(cell, seed, window.sampled, device)
    result = {"correct": bool(ok and failed == 0), "attempted": len(window.jobs), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if device.type == "cuda":
        dev_info["card"] = _power_limit()
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["solver"] = window.solver_name
    result["setup_phases_s"] = phases
    result["jobs_summary"] = summary(window)
    result["checks"] = checks
    return result


def check_lines(result: dict) -> list:
    return [f"check {name} = {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}" for name, c in result["checks"].items()]


def cli(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded before the run: {found}", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    t_import = time.perf_counter()
    guard.import_program(spec.ROOT)
    print(f"set-up: {t_import - t_start:.3f} s to the program's import, "
          f"{time.perf_counter() - t_import:.3f} s importing it", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    for line in check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
