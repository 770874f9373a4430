"""Profiling hooks (counterpart of ``pycsou_tpu/utils/profiling.py``):
``torch.profiler`` where the reference uses ``jax.profiler``.

    with trace("/tmp/tv_profile"), annotate("solve"):
        solver.run_fixed(100)

writes a Chrome trace (``chrome://tracing``, Perfetto) of the host's calls
and the card's kernels into the directory.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable

import torch

__all__ = ["trace", "annotate", "device_time"]


@contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU and, where there is a card, CUDA
    activities) and write its Chrome trace to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span on the profiler's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def _sync(out) -> None:
    """Wait for the devices of ``out``'s CUDA tensors (nothing for CPU
    tensors, whose work is done when the call returns)."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for v in out:
            _sync(v)
    elif isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def device_time(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Median wall seconds of one call ``fn(*args)``, each call waited for
    on the devices of its output's tensors."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
