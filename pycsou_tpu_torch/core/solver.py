"""Iterative solver driver: device-side history, chunked host sync.

Counterpart of ``pycsou_tpu/core/solver.py``.  The JAX package runs the
iteration inside ``lax.while_loop``, with the convergence test evaluated on
the device.  Here the host drives a Python loop that only enqueues work:
the metric and the per-iteration history stay on the device, and the host
reads them once per chunk of iterations (``solve``) or never
(``run_fixed``).  A solve therefore stops at the end of the chunk in which
the metric first fell to ``tol``: up to ``chunk - 1`` iterations past that
point (``SolveInfo.converged_at`` records the iteration itself).

``with_shardings`` records a sharded solve (see there): the port has no SPMD
partitioner, so the generic chain keeps its state whole on the first device
of this process's mesh positions; ``PDS`` routes a fused TV problem onto
the sharded solvers.

``solve(checkpoint_dir=...)`` saves the whole state (``utils/checkpoint.py``,
``torch.save`` where the reference writes Orbax) at the reference's
iterations and resumes from the newest loadable save.  ``remat`` is taken
for the reference's signature and changes nothing: a step here runs eagerly
and keeps no autograd graph across iterations, so there is nothing to
rematerialise (the reference wraps the step in ``jax.checkpoint``).

An iterand is a tensor, or for a sharded solver (``parallel.solvers``) a
tuple of per-shard tensors (a 2-D mesh: a tuple of row tuples of blocks;
on a mesh that spans processes a ``Remote`` for a block another process
holds); the metric, the histories and the counters live on the first local
shard's device.  On such a mesh every process steps the same solve and
reads the same metric history, so they stop together; a checkpoint holds
every position's blocks (gathered), written by the first process, so that
a save resumes under another number of processes.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from pycsou_tpu_torch._module import Module
from pycsou_tpu_torch.utils.checkpoint import load_latest_state, save_state
from pycsou_tpu_torch.utils.device import Remote, same_device

__all__ = ["IterativeSolver", "SolveInfo"]

_INF = float("inf")
# iterations between host reads of the metric in solve() (verbose overrides)
_SYNC_EVERY = 16
# iterations between checkpoints of solve(checkpoint_dir=...) (verbose
# overrides): the reference's chunk
_CHECKPOINT_CHUNK = 100
_HISTORY_KEYS = ("history", "var_history", "obj_history")


def _is_iterand(v) -> bool:
    """A tensor of at least one dimension, or a tuple of such (the shards of
    one variable, a ``Remote`` for another process's)."""
    if isinstance(v, tuple):
        return len(v) > 0 and all(isinstance(t, Remote) or _is_iterand(t) for t in v)
    return isinstance(v, torch.Tensor) and v.ndim >= 1


def _first_tensor(v) -> torch.Tensor:
    """The first tensor of a (nested) tuple of blocks, skipping ``Remote``
    entries."""
    if isinstance(v, tuple):
        return next((t for t in map(_first_tensor, v) if t is not None), None)
    return None if isinstance(v, Remote) else v


def _has_remote(v) -> bool:
    if isinstance(v, Remote):
        return True
    if isinstance(v, (tuple, list)):
        return any(_has_remote(e) for e in v)
    if isinstance(v, dict):
        return any(_has_remote(e) for e in v.values())
    return False


def _gathered(v):
    """``v`` with every tuple that holds ``Remote`` entries filled with the
    other processes' blocks (every process must call it)."""
    from pycsou_tpu_torch.parallel.mesh import gather_positions

    if isinstance(v, dict):
        return {k: _gathered(e) for k, e in v.items()}
    if isinstance(v, (tuple, list)):
        if any(isinstance(e, Remote) for e in v):
            return type(v)(gather_positions(v))
        return type(v)(_gathered(e) for e in v)
    return v


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
    # a solver that overrides metric() alone (PMYULA) measures something
    # else than its primary variable's improvement
    own = type(solver).metric is not IterativeSolver.metric and type(solver).metrics is IterativeSolver.metrics
    if rels is not None and not own and solver.primary_var in rels:
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
    """Result bundle: final iterand(s), iteration counts, metric history and,
    with ``track_objective``, the objective's (``objective_history``)."""

    def __init__(self, iterand: Dict[str, Any], n_iter: int, history: np.ndarray, converged: bool,
                 elapsed: float, diagnostics: Optional[Dict[str, np.ndarray]] = None,
                 converged_at: Optional[int] = None, objective_history: Optional[np.ndarray] = None):
        self.iterand = iterand
        self.n_iter = n_iter
        self.history = history
        self.converged = converged
        self.converged_at = converged_at
        self.elapsed = elapsed
        self.diagnostics = diagnostics or {}
        self.objective_history = objective_history

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
    the stopping metric from it rather than computing it twice, unless the
    subclass overrides :meth:`metric` and not :meth:`metrics`.

    ``track_objective`` fills ``obj_history`` (on the device) with
    :meth:`objective` of the primary iterand at every measured step;
    ``remat`` does nothing (see the module docstring).

    Example::

        >>> import torch, pycsou_tpu_torch as pt
        >>> dev = pt.get_default_device()  # the card, unless set to the CPU
        >>> from pycsou_tpu_torch.core.solver import IterativeSolver
        >>> class Richardson(IterativeSolver):
        ...     def __init__(self, b, **kw):
        ...         super().__init__(**kw)
        ...         self.b = b
        ...     def initial_state(self):
        ...         return {"x": torch.zeros_like(self.b)}
        ...     def step(self, state):
        ...         return {"x": state["x"] + 0.5 * (self.b - 2 * state["x"])}
        >>> info = Richardson(torch.tensor([2.0, 4.0], device=dev), tol=1e-6).solve()
        >>> info["x"].tolist(), bool(info.converged)
        ([1.0, 2.0], True)
    """

    # iterations one step() performs (it/history/max_iter count iterations)
    iters_per_step: int = 1
    primary_var: str = "x"
    # {state key -> NamedSharding} asked for by with_shardings (None: none)
    state_shardings: Optional[Dict[str, Any]] = None

    def __init__(self, max_iter: int = 500, min_iter: int = 10, tol: float = 1e-3,
                 verbose: Optional[int] = None, remat: bool = False, track_objective: bool = False,
                 metric_every: int = 1):
        self.max_iter = int(max_iter)
        self.min_iter = int(min_iter)
        self.tol = float(tol)
        self.verbose = verbose
        self.remat = bool(remat)
        self.track_objective = bool(track_objective)
        self.metric_every = int(metric_every)

    # -- sharded solves -----------------------------------------------------
    def _check_shardings(self, shardings) -> None:
        """The checks every ``with_shardings`` makes of ``shardings``
        (``parallel.mesh.NamedSharding``s keyed by state entry): each mesh's
        first device among this process's positions is the solver's own."""
        from pycsou_tpu_torch.parallel.mesh import NamedSharding

        meshes = []
        for key, sh in shardings.items():
            if not isinstance(sh, NamedSharding):
                raise TypeError(f"with_shardings({key}=...) takes a parallel.NamedSharding, not {type(sh).__name__}")
            if all(m is not sh.mesh for m in meshes):
                meshes.append(sh.mesh)
        own = getattr(self, "device", None)
        for m in meshes:
            first = m.local_device
            if own is not None and not same_device(first, own):
                raise ValueError(f"with_shardings: the first device of this process's mesh positions is {first}, "
                                 f"the {type(self).__name__}'s device is {own}; build the solver on {first} "
                                 "or give a mesh whose positions here start on its device")

    def with_shardings(self, **shardings) -> "IterativeSolver":
        """A copy of the solver whose ``state_shardings`` records
        ``shardings`` (``parallel.NamedSharding``s keyed by state entry).

        The reference partitions the whole solve with GSPMD.  The port has no
        SPMD partitioner, so on the generic chain each state entry stays
        whole on the mesh's first device, which must be the solver's own
        (``ValueError`` otherwise), and :meth:`postprocess` returns whole
        tensors: the iterates are the unsharded chain's, bit for bit.  The
        work spreads over the mesh only through mesh-aware operators
        (``parallel.ShardedDenseOperator``, ``ShardedBlockDiagonalOperator``,
        ``PencilCircularConv2D``), and an operator keeps its kernels: the
        reference's ``strip_pallas`` has no counterpart, since its only
        cause, a ``pallas_call`` that does not partition, is absent here.
        ``PDS``, ``APGD``, ``TVDeconvolution``, ``PMYULA`` and
        ``LassoDeconvolution`` route or switch engines first (see theirs).
        On a mesh that spans processes, "the mesh's first device" is the
        first device of this process's positions: the generic chain runs
        whole on every process there, and its checkpoints are written by
        the first process."""
        self._check_shardings(shardings)
        return self.replace(state_shardings=dict(shardings))

    # -- to implement ------------------------------------------------------
    def initial_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self, state: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def objective(self, x) -> torch.Tensor:
        """The objective at the primary iterand ``x`` (``track_objective``)."""
        raise NotImplementedError(f"{type(self).__name__} defines no objective")

    def metric(self, old, new) -> torch.Tensor:
        """Relative improvement of the primary iterand."""
        return _rel_improvement(old[self.primary_var], new[self.primary_var])

    def diagnostics_vars(self, state):
        """State entries tracked in the per-variable diagnostics."""
        reserved = {"it", "metric"} | set(_HISTORY_KEYS)
        return tuple(
            k for k, v in state.items()
            if k not in reserved and not k.startswith("_") and _is_iterand(v)
        )

    def metrics(self, old, new) -> Dict[str, torch.Tensor]:
        return {k: _rel_improvement(old[k], new[k]) for k in self.diagnostics_vars(old)}

    def postprocess(self, state):
        """User-facing iterand: drops histories and "_"-prefixed entries."""
        return {k: v for k, v in state.items() if k not in _HISTORY_KEYS and not k.startswith("_")}

    # -- driver ------------------------------------------------------------
    def _device(self, state) -> torch.device:
        """The device of the primary iterand's first local block."""
        return _first_tensor(state[self.primary_var]).device

    def _spans_processes(self, state) -> bool:
        """Whether the solve runs on a mesh that spans processes: its state
        holds another process's blocks, or a sharding names such a mesh."""
        meshes = [sh.mesh for sh in (self.state_shardings or {}).values()]
        return _has_remote(state) or any(m.spans_processes for m in meshes)

    def _save(self, path: str, state) -> None:
        """``save_state`` of ``state``; on a mesh that spans processes every
        position's blocks gathered first, then written by the first process
        between two barriers (so that no process reads a save in flight)."""
        if not self._spans_processes(state):
            save_state(path, state)
            return
        full = _gathered(state)
        torch.distributed.barrier()
        if torch.distributed.get_rank() == 0:
            save_state(path, full)
        torch.distributed.barrier()

    def _stride(self) -> int:
        return max(1, self.metric_every) * max(1, self.iters_per_step)

    def _wrap_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        state = dict(state)
        for key, sh in (self.state_shardings or {}).items():
            v = state.get(key)
            if isinstance(v, torch.Tensor):
                # the reference's device_put: a shape that does not divide
                # raises; the entry stays whole on the mesh's first device
                sh.check_shape(tuple(v.shape))
                state[key] = v.to(sh.mesh.local_device)
        dev = self._device(state)
        state.setdefault("it", 0)
        state["it"] = int(state["it"])
        eff = self._stride()
        n_hist = (-(-self.max_iter // eff) + 1) * eff
        # each made on the device (a fill, no copy from the host) and only
        # when the state lacks it: a run continued from a state reads no host
        fresh = {"metric": ((), _INF), "history": ((n_hist,), float("nan"))}
        n_vars = len(self.diagnostics_vars(state))
        if n_vars > 1:
            fresh["var_history"] = ((n_hist, n_vars), float("nan"))
        if self.track_objective:
            fresh["obj_history"] = ((n_hist,), float("nan"))
        for key, (shape, value) in fresh.items():
            if key not in state:
                state[key] = torch.full(shape, value, dtype=torch.float32, device=dev)
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

    def solve(self, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1) -> SolveInfo:
        """Run until the metric reaches ``tol`` (after ``min_iter``) or
        ``max_iter``, reading the metric history once per chunk.

        With ``checkpoint_dir`` the solve first resumes from the newest
        loadable checkpoint there (``utils.checkpoint.load_latest_state``;
        a sharded state goes back onto the template's devices), then saves
        the whole state as ``step_{it}`` at the end of every
        ``checkpoint_every``-th chunk of 100 iterations (``verbose`` when
        set) counted from where it started, and when it stops: the
        reference's iterations.  On a mesh that spans processes every
        process loads the save and keeps its own positions' blocks, and the
        first process writes (:meth:`_save`)."""
        state = self._own(self._wrap_state(self.initial_state()))
        if checkpoint_dir is not None:
            resumed = load_latest_state(checkpoint_dir, template=state)
            if resumed is not None:
                state = resumed
        chunk = max(self._stride(), int(self.verbose or _SYNC_EVERY))
        save_chunk = max(self._stride(), int(self.verbose or _CHECKPOINT_CHUNK))
        checkpoint_every = max(1, int(checkpoint_every))
        save_stop = min(state["it"] + save_chunk, self.max_iter)
        n_chunks = 0
        converged_at = None
        t0 = time.perf_counter()
        while True:
            it0 = state["it"]
            it_stop = min(it0 + chunk, self.max_iter)
            if checkpoint_dir is not None:
                it_stop = min(it_stop, save_stop)
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
            done = converged_at is not None or it >= self.max_iter
            if checkpoint_dir is not None and (it >= save_stop or done):
                n_chunks += 1
                if n_chunks % checkpoint_every == 0 or done:
                    self._save(f"{checkpoint_dir}/step_{it}", state)
                save_stop = min(it + save_chunk, self.max_iter)
            if done:
                break
        elapsed = time.perf_counter() - t0
        diagnostics = None
        if "var_history" in state:
            names = sorted(self.diagnostics_vars(state))
            vh = state["var_history"][:it].cpu().numpy()
            diagnostics = {name: vh[:, i] for i, name in enumerate(names)}
        obj = state["obj_history"][:it].cpu().numpy() if "obj_history" in state else None
        return SolveInfo(
            self.postprocess(state), it, state["history"][:it].cpu().numpy(),
            converged_at is not None, elapsed, diagnostics=diagnostics, converged_at=converged_at,
            objective_history=obj,
        )

    def iterate(self) -> SolveInfo:
        """The reference's alias of :meth:`solve`."""
        return self.solve()

    def iterates(self, n: int, stride: int = 1):
        """Generator of ``postprocess(state)`` every ``stride`` iterations
        over ``n`` iterations from the initial state; the stride rounds up to
        whole steps (``iters_per_step``), so that every yield advances."""
        ips = max(1, self.iters_per_step)
        stride = -(-int(stride) // ips) * ips
        state = self._wrap_state(self.initial_state())
        for _ in range(0, int(n), stride):
            state = self.run_fixed(stride, state=state)
            yield self.postprocess(state)
