"""Iterative solver driver: device-side history, chunked host sync.

Counterpart of ``pycsou_tpu/core/solver.py``.  The JAX package runs the
iteration inside ``lax.while_loop``, with the convergence test evaluated on
the device.  Here the host drives a Python loop that only enqueues work:
the metric and the per-iteration history stay on the device, and the host
reads them once per chunk of iterations (``solve``) or never
(``run_fixed``).  A solve therefore stops at the end of the chunk in which
the metric first fell to ``tol``: up to ``chunk - 1`` iterations past that
point (``SolveInfo.converged_at`` records the iteration itself).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from pycsou_tpu_torch._module import Module

__all__ = ["IterativeSolver", "SolveInfo"]

_INF = float("inf")
# iterations between host reads of the metric in solve() (verbose overrides)
_SYNC_EVERY = 16
_HISTORY_KEYS = ("history", "var_history", "obj_history")


def _rel_from_sums(d2, o2) -> torch.Tensor:
    """``sqrt(d2) / sqrt(o2)``: inf from a zero iterand that moved, 0 from a
    zero iterand that stayed (the reference's conventions)."""
    nd, no = torch.sqrt(d2), torch.sqrt(o2)
    inf = torch.full_like(nd, _INF)
    return torch.where(
        no == 0,
        torch.where(nd == 0, torch.zeros_like(nd), inf),
        nd / torch.where(no == 0, torch.ones_like(no), no),
    )


def _rel_improvement(a_old, a_new) -> torch.Tensor:
    """``||new - old|| / ||old||`` with the 0/inf rules of
    :func:`_rel_from_sums`."""
    d = a_new - a_old
    return _rel_from_sums(torch.sum(d * d), torch.sum(a_old * a_old))


def _advance(solver, s, new):
    """Bookkeeping after one measured step: metric, histories."""
    rels = solver.metrics(s, new) if "var_history" in s else None
    if rels is not None and solver.primary_var in rels:
        m = rels[solver.primary_var]  # == metric(): computed once
    else:
        m = solver.metric(s, new)
    it = s["it"] + solver.iters_per_step
    new["it"] = it
    new["metric"] = m
    hist = s["history"]
    hist[it - 1] = m  # in place: the run owns its history buffers (_own)
    new["history"] = hist
    if rels is not None:
        vh = s["var_history"]
        vh[it - 1] = torch.stack([rels[k] for k in sorted(rels)])
        new["var_history"] = vh
    if "obj_history" in s:
        oh = s["obj_history"]
        oh[it - 1] = solver.objective(new[solver.primary_var])
        new["obj_history"] = oh
    return new


def _raw_step(solver, st):
    """One step without bookkeeping (unmeasured rows of a stride)."""
    new = solver.step(st)
    new["it"] = st["it"] + solver.iters_per_step
    for key in ("metric",) + _HISTORY_KEYS:
        if key in st:
            new[key] = st[key]
    return new


def _stride_body(solver, s):
    """``metric_every - 1`` raw steps, then one measured step; skipped
    history rows stay NaN ("not measured")."""
    for _ in range(max(1, solver.metric_every) - 1):
        s = _raw_step(solver, s)
    return _advance(solver, s, solver.step(s))


class SolveInfo:
    """Result bundle: final iterand(s), iteration counts, metric history."""

    def __init__(self, iterand: Dict[str, Any], n_iter: int, history: np.ndarray, converged: bool,
                 elapsed: float, diagnostics: Optional[Dict[str, np.ndarray]] = None,
                 converged_at: Optional[int] = None):
        self.iterand = iterand
        self.n_iter = n_iter
        self.history = history
        self.converged = converged
        self.converged_at = converged_at
        self.elapsed = elapsed
        self.diagnostics = diagnostics or {}

    def __getitem__(self, key):
        return self.iterand[key]

    def __repr__(self):
        last = self.history[self.n_iter - 1] if self.n_iter else float("inf")
        return (
            f"SolveInfo(n_iter={self.n_iter}, converged={self.converged}, "
            f"converged_at={self.converged_at}, final_metric={last:.3e}, "
            f"elapsed={self.elapsed:.3f}s)"
        )


class IterativeSolver(Module):
    """Base driver.  Subclasses implement :meth:`initial_state` (a dict of
    tensors) and :meth:`step` (one iteration, which never touches the
    ``it``/``metric``/history keys); :meth:`metric` defaults to the
    relative improvement of ``x``.  Where :meth:`metrics` has an entry for
    ``primary_var``, that entry must equal :meth:`metric`: the driver takes
    the stopping metric from it rather than computing it twice."""

    # iterations one step() performs (it/history/max_iter count iterations)
    iters_per_step: int = 1
    primary_var: str = "x"

    def __init__(self, max_iter: int = 500, min_iter: int = 10, tol: float = 1e-3,
                 verbose: Optional[int] = None, metric_every: int = 1):
        self.max_iter = int(max_iter)
        self.min_iter = int(min_iter)
        self.tol = float(tol)
        self.verbose = verbose
        self.metric_every = int(metric_every)

    # -- to implement ------------------------------------------------------
    def initial_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self, state: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def metric(self, old, new) -> torch.Tensor:
        """Relative improvement of the primary iterand."""
        return _rel_improvement(old[self.primary_var], new[self.primary_var])

    def diagnostics_vars(self, state):
        """State entries tracked in the per-variable diagnostics."""
        reserved = {"it", "metric"} | set(_HISTORY_KEYS)
        return tuple(
            k for k, v in state.items()
            if k not in reserved and not k.startswith("_")
            and isinstance(v, torch.Tensor) and v.ndim >= 1
        )

    def metrics(self, old, new) -> Dict[str, torch.Tensor]:
        return {k: _rel_improvement(old[k], new[k]) for k in self.diagnostics_vars(old)}

    def postprocess(self, state):
        """User-facing iterand: drops histories and "_"-prefixed entries."""
        return {k: v for k, v in state.items() if k not in _HISTORY_KEYS and not k.startswith("_")}

    # -- driver ------------------------------------------------------------
    def _device(self, state) -> torch.device:
        return state[self.primary_var].device

    def _stride(self) -> int:
        return max(1, self.metric_every) * max(1, self.iters_per_step)

    def _wrap_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        state = dict(state)
        dev = self._device(state)
        state.setdefault("it", 0)
        state["it"] = int(state["it"])
        state.setdefault("metric", torch.tensor(_INF, dtype=torch.float32, device=dev))
        eff = self._stride()
        n_hist = (-(-self.max_iter // eff) + 1) * eff
        state.setdefault("history", torch.full((n_hist,), float("nan"), device=dev))
        n_vars = len(self.diagnostics_vars(state))
        if n_vars > 1:
            state.setdefault("var_history", torch.full((n_hist, n_vars), float("nan"), device=dev))
        return state

    @staticmethod
    def _own(state):
        """Private copies of the history buffers, which the run then updates
        in place (a state a caller still holds is never written)."""
        return {k: (v.clone() if k in _HISTORY_KEYS else v) for k, v in state.items()}

    def _grow_history(self, state, upto: int):
        """Pad the history buffers (doubling) when a run goes past them."""
        eff = self._stride()
        need = (-(-upto // eff) + 1) * eff
        cur = state["history"].shape[0]
        if need <= cur:
            return state
        new_size = cur
        while new_size < need:
            new_size *= 2
        state = dict(state)
        for key in _HISTORY_KEYS:
            if key in state:
                h = state[key]
                pad = torch.full((new_size - cur,) + tuple(h.shape[1:]), float("nan"), device=h.device)
                state[key] = torch.cat([h, pad])
        return state

    def run_fixed(self, n_iter: int, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run exactly ``n_iter`` iterations (rounded up to whole steps) with
        no convergence test and no host sync."""
        state = self._wrap_state(self.initial_state() if state is None else state)
        state = self._own(self._grow_history(state, state["it"] + int(n_iter)))
        eff, ips = self._stride(), max(1, self.iters_per_step)
        n_outer, rem = divmod(int(n_iter), eff)
        for _ in range(n_outer):
            state = _stride_body(self, state)
        rem_steps = -(-rem // ips)
        if rem_steps:
            for _ in range(rem_steps - 1):
                state = _raw_step(self, state)
            state = _advance(self, state, self.step(state))
        return state

    def solve(self) -> SolveInfo:
        """Run until the metric reaches ``tol`` (after ``min_iter``) or
        ``max_iter``, reading the metric history once per chunk."""
        state = self._own(self._wrap_state(self.initial_state()))
        chunk = max(self._stride(), int(self.verbose or _SYNC_EVERY))
        converged_at = None
        t0 = time.perf_counter()
        while True:
            it0 = state["it"]
            it_stop = min(it0 + chunk, self.max_iter)
            while state["it"] < it_stop:
                state = _stride_body(self, state)
            it = state["it"]
            hist = state["history"][it0:it].cpu().numpy()  # the chunk's host sync
            rows = np.arange(it0 + 1, it + 1)
            hit = np.nonzero((hist <= self.tol) & (rows >= self.min_iter))[0]
            if self.verbose:
                print(f"iter {it:6d}   relative improvement {float(state['metric']):.4e}")
            if hit.size:
                converged_at = int(rows[hit[0]])
                break
            if it >= self.max_iter:
                break
        elapsed = time.perf_counter() - t0
        diagnostics = None
        if "var_history" in state:
            names = sorted(self.diagnostics_vars(state))
            vh = state["var_history"][:it].cpu().numpy()
            diagnostics = {name: vh[:, i] for i, name in enumerate(names)}
        return SolveInfo(
            self.postprocess(state), it, state["history"][:it].cpu().numpy(),
            converged_at is not None, elapsed, diagnostics=diagnostics, converged_at=converged_at,
        )
