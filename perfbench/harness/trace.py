"""The profiler's trace of a window, reduced to what the metric readers
read: the benchmark's spans (``record_function`` ranges named
``perfbench.<span>``), the window, and every operation that ran on the
device (kernels, copies, fills), all on the profiler's one clock.

An operation belongs to a span when it starts inside it.  That is exact
for these jobs: a ``solve()`` ends with a host read of its metric, after
its last launch has run, and the build span of a traced run ends after the
device's queue drains."""
from __future__ import annotations

import bisect
import sys
import time
from dataclasses import dataclass, field

from perfbench.harness.jobs import SPAN_PREFIX

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"


@dataclass
class Trace:
    window: tuple  # (start_ns, end_ns)
    spans: dict  # span name -> sorted [(start_ns, end_ns)]
    ops: list  # sorted [(start_ns, end_ns, name, kind)]
    _starts: list = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def ops_in(self, span: str, kinds=DEVICE_KINDS):
        """The device operations of ``kinds`` that start inside a ``span``."""
        if self._starts is None:
            self._starts = [o[0] for o in self.ops]
        out = []
        for s, e in self.spans.get(span, ()):
            lo, hi = bisect.bisect_left(self._starts, s), bisect.bisect_left(self._starts, e)
            out.extend(o for o in self.ops[lo:hi] if o[3] in kinds)
        return out

    def span_seconds(self, span: str) -> float:
        return sum(e - s for s, e in self.spans.get(span, ())) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window."""
        w0, w1 = self.window
        merged = []
        for s, e, _, _ in self.ops:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def host_span_at(self, t: int) -> str:
        for name, spans in self.spans.items():
            if name == WINDOW:
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                return name
        return "between jobs"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name, summed) and
        the longest idle gaps of the device, each named by the span open on
        the host at its middle."""
        by_name = {}
        for s, e, name, _ in self.ops:
            by_name[name] = by_name.get(name, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.window[0]
        for s, e in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if s > prev:
                gaps.append((s - prev, self.host_span_at((s + prev) // 2)))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[0])
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[label, ns / 1e9] for ns, label in gaps[:top]]}


def _device_kind(name: str) -> str:
    """A device event's kind, told by its name: torch 2.11's profiler gives
    its events no ``activity_type``."""
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def _kineto_events(prof):
    """``(name, on_device, kind, start_ns, end_ns)`` of the profiler's raw
    device events and user annotations (the host's other events are
    skipped unread)."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type() == DeviceType.CUDA
        annotation = ev.is_user_annotation()
        if not on_device and not annotation:
            continue
        name = ev.name()
        if not on_device:
            kind = "user_annotation"
        elif annotation:
            kind = "gpu_user_annotation"
        else:
            kind = _device_kind(name)
        s = ev.start_ns()
        yield name, on_device, kind, s, s + ev.duration_ns()


def _collect(events):
    spans, ops, seen = {}, [], {}
    for name, on_device, kind, s, e in events:
        seen[(on_device, kind)] = seen.get((on_device, kind), 0) + 1
        ours = name.startswith(SPAN_PREFIX)
        if on_device:
            if not ours and kind in DEVICE_KINDS:
                ops.append((s, e, name, kind))
        elif ours:
            spans.setdefault(name[len(SPAN_PREFIX):], []).append((s, e))
    return spans, ops, seen


def reduce(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    t0 = time.perf_counter()
    spans, ops, seen = _collect(_kineto_events(prof))
    print(f"trace: {len(ops)} device operations read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if WINDOW not in spans:
        raise RuntimeError(f"the trace holds no window span; events by (on device, kind): {seen}")
    for v in spans.values():
        v.sort()
    ops.sort()
    return Trace(window=spans[WINDOW][0], spans=spans, ops=ops)
