"""Checkpoint and resume of solver states (counterpart of
``pycsou_tpu/utils/checkpoint.py``).

A solver state is a dict of tensors, Python numbers, and tuples, lists and
dicts of them: the shards of a sharded solver are a tuple of tensors (a
grid of blocks a tuple of row tuples), PMYULA's P^2 states lists of dicts,
the iteration counter ``it`` a Python int.  :func:`save_state` writes it
with ``torch.save``, every tensor moved to the CPU, where the reference
writes an Orbax checkpoint; a JAX state enters the port only through
``utils/convert.py``.

A save writes a staging file whose name after ``step_`` is not an integer
and renames it onto its name (``os.replace``): a save killed midway leaves
a staging file that :func:`checkpoint_steps` never lists, or an older
complete file.  :func:`load_state` reads with ``torch.load(...,
weights_only=True)``; given a template (the solver's fresh state), it
checks the keys, the nesting of tuples and lists, each tensor's shape and
dtype and each number's type, grows the history buffers when the solve
resumes with a larger ``max_iter`` (the new rows NaN, "not measured") and
puts each tensor on its template tensor's device, so that the shards of a
sharded state return to their mesh devices.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Optional

import torch

__all__ = ["save_state", "load_state", "latest_checkpoint", "checkpoint_steps", "load_latest_state"]

_HISTORY_KEYS = ("history", "var_history", "obj_history")


def _to_cpu(v):
    if isinstance(v, dict):
        return {k: _to_cpu(e) for k, e in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to_cpu(e) for e in v)
    if isinstance(v, torch.Tensor):
        v = v.detach()
        # a CPU tensor may be a view: clone it, so that only its own
        # elements are written
        return v.clone() if v.device.type == "cpu" else v.cpu()
    return v


def save_state(path: str, state: Any) -> None:
    """Write a solver state to ``path`` (replacing it): every tensor on the
    CPU, through a staging file renamed onto ``path`` once written and
    flushed to disk."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.staging-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(_to_cpu(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _match(r, t, where: str, key=None):
    """``r`` (loaded) checked against the template ``t`` and placed on its
    devices; ``key`` is the state's top-level key (the histories may grow)."""
    if isinstance(t, dict):
        if not isinstance(r, dict) or set(r) != set(t):
            got = sorted(r) if isinstance(r, dict) else type(r).__name__
            raise ValueError(f"checkpoint {where or 'state'}: keys {got} != template keys {sorted(t)}")
        return {k: _match(r[k], t[k], f"{where}[{k!r}]", k if not where else key) for k in t}
    if isinstance(t, (tuple, list)):
        if type(r) is not type(t) or len(r) != len(t):
            got = f"{type(r).__name__} of {len(r)}" if isinstance(r, (tuple, list)) else type(r).__name__
            raise ValueError(f"checkpoint {where}: {got} != template {type(t).__name__} of {len(t)} "
                             "(another mesh?)")
        return type(t)(_match(a, b, f"{where}[{i}]", key) for i, (a, b) in enumerate(zip(r, t)))
    if isinstance(t, torch.Tensor):
        if not isinstance(r, torch.Tensor):
            raise ValueError(f"checkpoint {where}: {type(r).__name__} != template tensor")
        if r.dtype != t.dtype:
            raise ValueError(f"checkpoint {where}: dtype {r.dtype} != template {t.dtype}")
        if r.shape != t.shape:
            grown = (key in _HISTORY_KEYS and r.ndim == t.ndim and r.shape[1:] == t.shape[1:]
                     and r.shape[0] <= t.shape[0])
            if not grown:
                raise ValueError(f"checkpoint {where}: shape {tuple(r.shape)} != template {tuple(t.shape)} "
                                 "(solver reconfigured? another metric_every or history size?)")
            # resumed with a larger max_iter: the new rows are not measured
            pad = torch.full((t.shape[0] - r.shape[0],) + tuple(r.shape[1:]), float("nan"), dtype=r.dtype)
            r = torch.cat([r, pad])
        return r.to(t.device)
    if type(r) is not type(t):
        raise ValueError(f"checkpoint {where}: {type(r).__name__} != template {type(t).__name__}")
    return r


def load_state(path: str, template: Optional[Any] = None) -> Any:
    """Read a solver state written by :func:`save_state`.  Without a
    template its tensors stay on the CPU; with one, the state is checked
    against it (``ValueError`` on a mismatch) and each tensor goes to its
    template tensor's device."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return state if template is None else _match(state, template, "")


def checkpoint_steps(directory: str) -> list:
    """The complete checkpoints ``step_{it}`` of ``directory``, newest step
    first; a staging file (a save in flight or killed) has no integer after
    ``step_`` and is left out."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            steps.append((int(name[len("step_"):]), name))
        except ValueError:
            continue
    steps.sort(reverse=True)
    return [os.path.join(directory, name) for _, name in steps]


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest checkpoint of ``directory`` (by step), or None."""
    steps = checkpoint_steps(directory)
    return steps[0] if steps else None


def load_latest_state(directory: str, template: Optional[Any] = None) -> Optional[Any]:
    """The newest checkpoint of ``directory`` that loads, or None when it
    holds none.  A newer file that fails (torn by a kill, or unreadable) is
    skipped with a warning; when every file fails, the state no longer fits
    the solver (reconfigured?) and this raises ``RuntimeError`` rather than
    let the solve restart from iteration 0."""
    errors = []
    for path in checkpoint_steps(directory):
        try:
            state = load_state(path, template)
        except Exception as e:  # a torn write, a foreign file, a mismatch: try the next
            errors.append((path, e))
            continue
        if errors:
            warnings.warn(f"skipped {len(errors)} unreadable newer checkpoint(s) ({errors[-1][0]}: "
                          f"{errors[-1][1]!r}); resumed from {path}")
        return state
    if errors:
        raise RuntimeError(f"all {len(errors)} checkpoint(s) in {directory} failed to load; does the state "
                           f"still fit the solver? newest error: {errors[0][0]}: {errors[0][1]!r}")
    return None
