"""Whether a run's outputs are correct: each sampled job's ``x`` and its
stopping iteration against the plain reference (``reference/<config>.py``)
run in float64 on the same inputs, which the configuration's module makes
again from the seed.

The numbers compared, each held to its limit in the configuration file:

* ``x_rel_l2``: ``||x - x_ref|| / ||x_ref||`` after the job's own number of
  iterations (``SolveInfo.n_iter``);
* ``x_rel_max``: ``max |x - x_ref| / max |x_ref|``, the same;
* ``stop_gap``: iterations between the job's ``converged_at`` and the first
  iteration at or after ``min_iter`` whose relative improvement is at most
  the tolerance in the reference (a solve that met none counts as
  ``max_iter + 1``).

The control puts the reference computed in a lower precision in the
program's place (:func:`control_record`)."""
from __future__ import annotations

import math

import torch

NUMBERS = ("x_rel_l2", "x_rel_max", "stop_gap")
EXTRA = 64  # iterations the reference runs past the job's convergence to find its own


def readings(cell, inputs: dict, n_iter: int, converged_at, x, device) -> dict:
    """The numbers of one job, against the float64 reference."""
    t = cell.traffic
    max_iter, min_iter, tol = int(t["max_iter"]), int(t["min_iter"]), float(t["tol"])
    ref = cell.reference_module()
    n_run = min(max_iter, max(n_iter, (converged_at or 0) + EXTRA))
    run = ref.solve(inputs, cell.config, device, n_compare=n_iter, n_run=n_run, tol=tol, min_iter=min_iter,
                    dtype=torch.float64)
    x_ref = run.x
    xx = torch.as_tensor(x).to(device=device, dtype=torch.float64)
    if tuple(xx.shape) != tuple(x_ref.shape):
        l2 = mx = math.inf
    else:
        l2 = float(torch.linalg.vector_norm(xx - x_ref) / torch.linalg.vector_norm(x_ref))
        mx = float(torch.max(torch.abs(xx - x_ref)) / torch.max(torch.abs(x_ref)))
    c_prog = converged_at if converged_at is not None else max_iter + 1
    c_ref = run.crossed if run.crossed is not None else run.n_run + 1
    return {"x_rel_l2": l2, "x_rel_max": mx, "stop_gap": float(abs(c_prog - c_ref))}


def control_record(cell, inputs: dict, device, dtype=torch.bfloat16):
    """The reference in ``dtype`` run as a solver would be: to the first
    iteration at or after ``min_iter`` whose metric is at most the
    tolerance, or ``max_iter``; ``(n_iter, converged_at, x)``."""
    t = cell.traffic
    run = cell.reference_module().solve(
        inputs, cell.config, device, n_compare=int(t["min_iter"]), n_run=int(t["max_iter"]),
        tol=float(t["tol"]), min_iter=int(t["min_iter"]), dtype=dtype, stop_at_crossing=True)
    return run.n_run, run.crossed, run.x_end.float()


def worst(all_readings) -> dict:
    """The largest of each number over the jobs compared (NaN wins)."""
    out = {}
    for name in NUMBERS:
        vals = [r[name] for r in all_readings]
        out[name] = math.nan if any(math.isnan(v) for v in vals) else max(vals)
    return out


def judge(values: dict, limits: dict):
    """``(ok, checks)``: every number at or below its limit (NaN fails)."""
    checks = {name: {"value": values[name], "limit": float(limits[name])} for name in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def check_jobs(cell, seed: int, sampled, device):
    """``(ok, checks)`` of a run's sampled jobs (none sampled: not ok)."""
    mod = cell.config_module()
    all_readings = []
    for rec in sampled:
        inputs = mod.reference_inputs(cell.config, cell.shape, seed, rec.item, device)
        all_readings.append(readings(cell, inputs, rec.n_iter, rec.converged_at, rec.x, device))
        del inputs
    if not all_readings:
        return False, {name: {"value": math.nan, "limit": float(cell.config["limits"][name])}
                       for name in NUMBERS}
    return judge(worst(all_readings), cell.config["limits"])
