"""Set-up, jobs and the measured window of one cell.

A job is what a user of the port does for one image: (upload the frame,)
(build the ``PDS``,) ``solve()`` to the tolerance and bring ``x`` to the
host, into a pinned buffer as a pipeline does (a fresh pageable buffer's
page faults made the copy's time vary from run to run).  The traffic file
says which of these the job does and which are done once in set-up; the
configuration's module makes the inputs from the seed and builds the entry
through the port's user API.  The window is
closed-loop, one job at a time: it ends when the first job completes after
``seconds``, so no job is cut in half."""
from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback
from dataclasses import dataclass

import torch

from perfbench.harness.stats import Reservoir

SPAN_PREFIX = "perfbench."
SPANS = ("upload", "build", "solve", "readback")


@dataclass
class JobRecord:
    index: int  # the job's number in the window
    item: int  # its observation in the pool
    latency_s: float  # from its start to x on the host
    n_iter: int = 0
    converged_at: int = None
    failed: bool = False
    steps_s: dict = None  # host seconds of each step (SPANS)
    x: torch.Tensor = None  # on the host; kept for sampled jobs only


@dataclass
class Window:
    jobs: list
    window_s: float
    sampled: list
    solver_name: str = ""


def describe(solver) -> str:
    """The solver class, and the fused engine the port's matcher chose."""
    fused = getattr(solver, "_fused", None)
    if fused is None:
        return f"{type(solver).__name__} (generic chain)"
    return f"{type(solver).__name__} -> {type(fused).__name__}[{getattr(fused, 'stencil_mode', '?')}]"


class Setup:
    """The inputs and the program's objects of one run of a cell."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.mod = cell.config_module()
        shape = cell.shape
        t = self.traffic
        self.pool_size = int(t["pool"])
        self.upload = bool(t.get("upload", False))
        self.build_in_job = t.get("build", "setup") == "job"
        self.shared = self.mod.shared_inputs(self.cfg, shape, self.seed, self.device)
        self.instrument = self.mod.instrument(self.cfg, shape, self.shared, self.device)
        ys = [self.mod.observation(self.cfg, shape, self.seed, k, self.shared, self.device)
              for k in range(self.pool_size)]
        self.host_ys = [y.cpu().pin_memory() if self.device.type == "cuda" else y.cpu()
                        for y in ys] if self.upload else None
        self.ys = None if self.upload else ys
        self.solvers = None if self.build_in_job else [self._build(y) for y in ys]
        del ys
        self.traced = False
        # host buffers for x: one a job kept for the check, one for the job
        pinned = self.device.type == "cuda"
        self.free = [torch.empty(shape, dtype=torch.float32, pin_memory=pinned)
                     for _ in range(int(t.get("check_jobs", 1)) + 1)]

    def release(self, x) -> None:
        """Give a host buffer back once its job is no longer kept."""
        self.free.append(x)

    def _build(self, y):
        return self.mod.build(self.cfg, self.traffic, self.cell.shape, self.instrument, y)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A ``record_function`` range in traced runs (``sync``: ended after
        the device's queue drains); nothing in untraced ones."""
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def job(self, i: int):
        """Job ``i``: its pool item, the solver's ``SolveInfo``, ``x`` on the
        host, and the host seconds of each of its steps."""
        k = i % self.pool_size
        clock = [time.perf_counter()]
        if self.upload:
            with self.span("upload"):
                y = self.host_ys[k].to(self.device, non_blocking=True)
        else:
            y = self.ys[k]
        clock.append(time.perf_counter())
        if self.build_in_job:
            with self.span("build", sync=True):
                solver = self._build(y)
        else:
            solver = self.solvers[k]
        clock.append(time.perf_counter())
        with self.span("solve"):
            info = solver.solve()
        clock.append(time.perf_counter())
        with self.span("readback"):
            x = self.free.pop()
            try:
                x.copy_(info["x"])
            except BaseException:
                self.free.append(x)
                raise
        clock.append(time.perf_counter())
        self.solver_name = describe(solver)
        return k, info, x, dict(zip(SPANS, (b - a for a, b in zip(clock, clock[1:]))))

    def close(self) -> None:
        """Free the program's objects and the device inputs."""
        self.solvers = self.ys = self.host_ys = self.instrument = self.free = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def run_window(setup: Setup, seconds: float, check_jobs: int, seed: int, first_index: int = 0) -> Window:
    """Jobs back to back until the first one that completes after
    ``seconds``; ``check_jobs`` of them, drawn from ``seed``, keep ``x``."""
    sample = Reservoir(check_jobs, seed)
    jobs = []
    reported = False
    t_start = time.perf_counter()
    i = first_index
    while True:
        t0 = time.perf_counter()
        try:
            k, info, x, steps = setup.job(i)
        except Exception:  # a failed job is counted, and the window goes on
            t1 = time.perf_counter()
            jobs.append(JobRecord(i, i % setup.pool_size, t1 - t0, failed=True))
            if not reported:
                traceback.print_exc(file=sys.stderr)
                reported = True
        else:
            t1 = time.perf_counter()
            rec = JobRecord(i, k, t1 - t0, int(info.n_iter), info.converged_at, steps_s=steps)
            jobs.append(rec)
            dropped = sample.offer((rec, x))
            if dropped is not None:
                setup.release(dropped[1])
        i += 1
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    sampled = []
    for rec, x in sample.items:
        rec.x = x
        sampled.append(rec)
    return Window(jobs=jobs, window_s=window_s, sampled=sorted(sampled, key=lambda r: r.index),
                  solver_name=getattr(setup, "solver_name", ""))


def summary(window: Window) -> dict:
    """Means over the window's completed jobs (for the record; no metric)."""
    done = [j for j in window.jobs if not j.failed]
    if not done:
        return {"jobs": 0}
    out = {"jobs": len(done), "n_iter_mean": sum(j.n_iter for j in done) / len(done),
           "n_iter_min": min(j.n_iter for j in done), "n_iter_max": max(j.n_iter for j in done)}
    for step in SPANS:
        out[f"{step}_ms_mean"] = 1e3 * sum(j.steps_s[step] for j in done) / len(done)
    return out
