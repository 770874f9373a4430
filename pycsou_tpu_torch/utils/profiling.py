"""Profiling hooks (counterpart of ``pycsou_tpu/utils/profiling.py``):
``torch.profiler`` where the reference uses ``jax.profiler``.

    with trace("/tmp/tv_profile"), annotate("solve"):
        solver.run_fixed(100)

writes a Chrome trace (``chrome://tracing``, Perfetto) of the host's calls
and the card's kernels into the directory.

``annotate`` is the program's one span API, and ``count`` its counter.
While a profiler runs (``torch.profiler.profile``, :func:`trace`) a span
opens a ``record_function`` range on the profiler's timeline and keeps a
:class:`Span` record in memory: its name, its start and end in
``time.time_ns()`` (the clock of the profiler's events, so a record lies
over the device trace as it is), the index of the enclosing span and the
index of the outermost one (one a ``solve()`` call or a ``PDS(...)``
construction).  Without a profiler a span or a count costs one check of
the profiler's state and records nothing.  The program's spans:

* ``solve`` (``IterativeSolver.solve``), holding ``solve.start`` (the
  initial state and any resume), one ``solve.enqueue`` (a chunk's steps
  launched) and one ``solve.read`` (its metric history read on the host
  and the stop test) a chunk of iterations, and ``solve.finish`` (the
  histories read, ``postprocess``);
* ``pds.init`` (``PrimalDualSplitting(...)``), holding ``pds.match`` (the
  expression matched onto a fused engine, which the match builds);
  ``pds.route`` (``PDS.with_shardings``: the sharded solver's constructor);
* ``conv.lipschitz`` (the FFT bound on a convolution's norm);
* in a step of ``parallel.DistributedTVDeconv2D``'s shard engines,
  ``sp.halo`` (the neighbours' halo rows fetched) and ``sp.fold`` (the
  shards' partial sums added on the first device); ``sp.gather`` (its
  shards joined on the first device).

The counter ``solve.host_reads`` counts the reads of ``solve()`` that wait
for the device, ``pds.conv_reused`` the fused engines that took the user's
``Convolve2D`` as it is (``ops/conv.py`` ``engine_conv``), and
``sp.halo_bytes`` the bytes the halo exchanges copy between cards
(``parallel/spatial.py``).
:func:`records`, :func:`counters` and :func:`reset` read and clear what was
kept.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import torch

__all__ = ["trace", "annotate", "count", "records", "counters", "reset", "device_time", "Span"]

# True inside torch.profiler.profile (and trace()), false outside it
_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One span: ``start_ns``/``end_ns`` in ``time.time_ns()`` (``end_ns``
    None while open); ``parent`` the index in :func:`records` of the span
    it opened in (None at the top), ``request`` that of its outermost
    span."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    request: int


_lock = threading.Lock()
_records: List[list] = []  # [name, start_ns, end_ns, parent, request]
_counters: dict = {}
_open = threading.local()  # .stack: this thread's open spans, as (index, request)
_OFF = contextlib.nullcontext()


class _Annotation:
    __slots__ = ("name", "record", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent, request = stack[-1] if stack else (None, None)
        with _lock:
            index = len(_records)
            self.record = [self.name, time.time_ns(), None, parent, index if request is None else request]
            _records.append(self.record)
        stack.append((index, self.record[4]))
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.record[2] = time.time_ns()
        _open.stack.pop()
        return False


def annotate(name: str):
    """A named span: a ``record_function`` range and a :class:`Span` record
    while a profiler runs, a shared no-op context otherwise."""
    return _Annotation(name) if _profiling() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _profiling():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def records() -> List[Span]:
    """A copy of the spans kept so far, in the order they opened."""
    with _lock:
        return [Span(*r) for r in _records]


def counters() -> dict:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Drop the kept spans and counters (call it with no span open)."""
    with _lock:
        _records.clear()
        _counters.clear()


@contextlib.contextmanager
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
