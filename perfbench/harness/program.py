"""The program's own spans and counters in a traced window: what
``pycsou_tpu_torch.utils.profiling`` kept (``records()``, ``counters()``)
while the window's profiler ran.  A record's start and end are on the
clock of the profiler's events, so the records lie over the device trace
as they are: the spans inside ``solve()`` (``solve.start``,
``solve.enqueue``, ``solve.read``, ``solve.finish``) and inside
``PDS(...)`` (``pds.init``, ``pds.match``, ``conv.lipschitz``).

Nothing to read (None) in an untraced run, or from a program that keeps
no records (one older than its spans): a metric read from here is then
left out of the result line.  The first read of a trace takes what the
program kept and clears it, so that a later window in the same process
starts empty."""
from __future__ import annotations

import sys
from dataclasses import dataclass

from perfbench.harness.guard import PROGRAM

MODULE = PROGRAM + ".utils.profiling"
_taken = []  # [trace, Program] of the last trace read


@dataclass
class Program:
    spans: list  # closed records (name, start_ns, end_ns, parent, request) starting in the window
    counters: dict

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total_ns(self, name: str) -> int:
        return sum(s.end_ns - s.start_ns for s in self.named(name))

    def idle_ns_by_span(self, trace) -> dict:
        """The device's idle time in the window, by the innermost program
        span open on the host when each idle gap starts ("none" outside
        every span).  A gap is put down to where it starts: the turnaround
        of a chunk read starts in ``solve.read`` and ends in the next
        ``solve.enqueue``."""
        w0, w1 = trace.window
        gaps, prev = [], w0
        for s, e in trace.busy_intervals() + [[w1, w1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        spans = sorted(self.spans, key=lambda r: (r.start_ns, -r.end_ns))
        out, stack, i = {}, [], 0
        for g0, g1 in gaps:
            while i < len(spans) and spans[i].start_ns <= g0:
                while stack and stack[-1].end_ns <= spans[i].start_ns:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1].end_ns <= g0:
                stack.pop()
            name = stack[-1].name if stack else "none"
            out[name] = out.get(name, 0) + (g1 - g0)
        return out


def _api():
    mod = sys.modules.get(MODULE)
    if mod is None or not all(hasattr(mod, f) for f in ("records", "counters", "reset")):
        return None
    return mod


def read(ctx):
    """The :class:`Program` of ``ctx``'s traced window, or None."""
    if ctx.trace is None:
        return None
    if _taken and _taken[0] is ctx.trace:
        return _taken[1]
    api = _api()
    if api is None:
        return None
    records, counters = api.records(), api.counters()
    api.reset()
    w0, w1 = ctx.trace.window
    spans = [r for r in records if r.end_ns is not None and w0 <= r.start_ns < w1]
    _taken[:] = [ctx.trace, Program(spans=spans, counters=counters)]
    return _taken[1]


def per_solve(ctx, value_of):
    """``value_of(program)`` over the window's ``solve`` spans, or None."""
    prog = read(ctx)
    if prog is None:
        return None
    n = len(prog.named("solve"))
    value = value_of(prog) if n else None
    return None if value is None else value / n


def idle_ms_per_solve(ctx, names) -> float:
    """The idle time whose gaps start in one of the spans ``names``, in ms
    a solve; None where the trace holds no device operation."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return per_solve(ctx, lambda p: sum(p.idle_ns_by_span(ctx.trace).get(n, 0) for n in names) / 1e6)
