"""The program's spans and counters (``pycsou_tpu_torch/utils/profiling.py``)
on the CPU: nothing kept and no ``record_function`` entered without a
profiler; under one, the spans of ``PDS(...)`` and ``solve()`` nested as
the module docstring says, one request a call, the host reads counted, and
each record on the clock of the profiler's own events."""
import contextlib
import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pycsou_tpu_torch.func as tfunc
import pycsou_tpu_torch.ops as tops
import pycsou_tpu_torch.opt as topt
from pycsou_tpu_torch.utils import profiling
from pycsou_tpu_torch.utils.device import set_default_device

S = (48, 64)
LAM = 0.05
CHUNK = 16  # core/solver.py _SYNC_EVERY


@pytest.fixture(autouse=True)
def _on_cpu():
    set_default_device("cpu")
    profiling.reset()
    yield
    profiling.reset()
    set_default_device(None)


def _gauss(k=5, s=1.2):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    h = np.outer(g, g)
    return (h / h.sum()).astype(np.float32)


def _y(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.abs(rng.standard_normal(S)).astype(np.float32))
    y = tops.Convolve2D(S, _gauss()).apply(x)
    return (y + 0.01 * torch.from_numpy(rng.standard_normal(S).astype(np.float32))).contiguous()


def _pds(y, A=None, **kw):
    """The README's TV deconvolution (fused onto ``TVDeconvolution``)."""
    A = tops.Convolve2D(S, _gauss()) if A is None else A
    kw = {"max_iter": 80, "min_iter": 10, "accuracy_threshold": 1e-4, **kw}
    return topt.PDS(S, F=tfunc.SquaredL2Loss(S, data=y) * A, G=tfunc.NonNegativeOrthant(S),
                    H=LAM * tfunc.L21Norm((2,) + S, axis=0), K=tops.Gradient(S), **kw)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def test_nothing_is_kept_or_entered_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    y = _y()
    p = _pds(y)
    info = p.solve()
    assert info.n_iter > 0
    assert profiling.records() == [] and profiling.counters() == {}
    assert entered == []
    assert profiling.annotate("a") is profiling.annotate("b")  # one shared no-op context
    with profiling.annotate("a"):
        profiling.count("c", 3)
    assert profiling.records() == [] and profiling.counters() == {}


def test_pds_construction_records_match_and_lipschitz():
    # A built outside the profiler, as a user does once: the fused engine
    # takes it as it is, so the match computes no FFT bound
    y, A = _y(), tops.Convolve2D(S, _gauss())
    with _cpu_profile():
        p = _pds(y, A=A)
    assert p._fused is not None
    recs = profiling.records()
    assert [r.name for r in recs] == ["pds.init", "pds.match"]
    assert (recs[0].parent, recs[1].parent) == (None, 0)
    assert profiling.counters() == {"pds.conv_reused": 1}
    # a forced method: the engine builds its convolution from the taps again
    A = tops.Convolve2D(S, _gauss(), method="fft")
    profiling.reset()
    with _cpu_profile():
        p = _pds(y, A=A)
    assert p._fused is not None
    recs = profiling.records()
    assert [r.name for r in recs] == ["pds.init", "pds.match", "conv.lipschitz"]
    init, match, lip = recs
    assert (init.parent, match.parent, lip.parent) == (None, 0, 1)
    assert {r.request for r in recs} == {0}
    assert init.start_ns <= match.start_ns <= lip.start_ns <= lip.end_ns <= match.end_ns <= init.end_ns
    assert profiling.counters() == {}


@pytest.mark.parametrize("verbose,track_objective", [(None, False), (None, True), (CHUNK, False)],
                         ids=["plain", "objective", "verbose"])
def test_solve_records_its_chunks_and_counts_host_reads(verbose, track_objective, capsys):
    p = _pds(_y(), verbose=verbose)
    p.track_objective = track_objective
    if track_objective:
        p._fused.track_objective = True
    with _cpu_profile():
        info = p.solve()
    n_chunks = math.ceil(info.n_iter / CHUNK)
    assert n_chunks >= 2
    recs = profiling.records()
    assert recs[0].name == "solve" and recs[0].parent is None
    assert {r.request for r in recs} == {0}
    assert all(r.end_ns is not None and r.start_ns <= r.end_ns for r in recs)
    want = ["solve.start"] + ["solve.enqueue", "solve.read"] * n_chunks + ["solve.finish"]
    assert _children(recs, 0) == want
    assert len(recs) == 1 + len(want)  # the solve's children open no spans of their own
    kids = recs[1:]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert recs[0].start_ns <= kids[0].start_ns and kids[-1].end_ns <= recs[0].end_ns
    reads = n_chunks + 2 + int(track_objective) + (n_chunks if verbose else 0)
    assert profiling.counters() == {"solve.host_reads": reads}
    assert info.diagnostics  # var_history: the finish's second read
    if verbose:
        assert capsys.readouterr().out.count("relative improvement") == n_chunks


def test_each_request_has_its_own_id():
    y, A = _y(), tops.Convolve2D(S, _gauss())
    with _cpu_profile():
        p = _pds(y, A=A)
        p.solve()
        p.solve()
    recs = profiling.records()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["pds.init", "solve", "solve"]
    for i, r in enumerate(recs):
        assert r.request == (i if r.parent is None else recs[r.parent].request)
        assert r.request == max(j for j in roots if j <= i)
    assert profiling.counters()["solve.host_reads"] == 2 * (math.ceil(p.solve().n_iter / CHUNK) + 2)


def test_records_lie_on_the_clock_of_the_profiler_events():
    y, A = _y(), tops.Convolve2D(S, _gauss())
    with _cpu_profile() as prof:
        _pds(y, A=A).solve()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            events.setdefault(ev.name(), []).append(ev.start_ns())
    by_name = {}
    for r in profiling.records():
        by_name.setdefault(r.name, []).append(r.start_ns)
    assert set(by_name) <= set(events)
    for name, starts in by_name.items():
        assert len(starts) == len(events[name]), name
        for rec, ev in zip(sorted(starts), sorted(events[name])):
            assert abs(ev - rec) <= 1_000_000, (name, ev - rec)


def test_threads_keep_their_own_stacks(monkeypatch):
    # torch's profiler records on the threads that started it; here every
    # thread records, so that two stacks are open at once
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: contextlib.nullcontext())
    seen = {}

    def work(tag):
        with profiling.annotate(f"outer.{tag}"):
            barrier.wait(timeout=30)
            with profiling.annotate(f"inner.{tag}"):
                profiling.count("c")
            barrier.wait(timeout=30)

    barrier = threading.Barrier(2)
    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.records()
    for i, r in enumerate(recs):
        seen[r.name] = (i, r.parent, r.request)
    for tag in "ab":
        i, parent, request = seen[f"outer.{tag}"]
        assert parent is None and request == i
        assert seen[f"inner.{tag}"][1:] == (i, i)
    assert profiling.counters() == {"c": 2}


def test_reset_clears_records_and_counters():
    with _cpu_profile():
        with profiling.annotate("a"):
            profiling.count("n", 2)
    assert [r.name for r in profiling.records()] == ["a"] and profiling.counters() == {"n": 2}
    got = profiling.records()
    got.clear()
    profiling.counters().clear()
    assert len(profiling.records()) == 1 and profiling.counters() == {"n": 2}  # copies
    profiling.reset()
    assert profiling.records() == [] and profiling.counters() == {}
    with _cpu_profile():
        with profiling.annotate("b"):
            pass
    assert [(r.name, r.parent, r.request) for r in profiling.records()] == [("b", None, 0)]
