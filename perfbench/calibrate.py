"""The readings that a cell's correctness limits are set from, on the card
at the cell's own sizes (not run by the benchmark's runs):

* the program: for each seed, the cell's set-up, then ``--items`` jobs of
  its timed path (one for each pool item), each against the float64
  reference (``harness/check.py``);
* the control: for each control seed, the reference computed in bfloat16
  put in the program's place on pool item 0, against the same reference.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 --out <file.json>

Every reading is written to ``--out``, and the largest of the program's
and the smallest of the control's are printed last."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _ints(text):
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    from perfbench.harness import check, guard, spec
    from perfbench.harness.jobs import Setup

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--items", type=int, default=None, help="jobs a seed (default: the pool)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    guard.import_program(spec.ROOT)
    out = {"workload": cell.name, "program": [], "control": []}
    for seed in args.seeds:
        setup = Setup(cell, seed, device)
        n = min(args.items or setup.pool_size, setup.pool_size)
        recs = []
        for k in range(n):
            t0 = time.perf_counter()
            _, info, x, _ = setup.job(k)
            recs.append((k, int(info.n_iter), info.converged_at, x.clone(), time.perf_counter() - t0))
            setup.release(x)
        solver = setup.solver_name
        setup.close()
        for k, n_iter, conv, x, lat in recs:
            inputs = cell.config_module().reference_inputs(cell.config, cell.shape, seed, k, device)
            t0 = time.perf_counter()
            r = check.readings(cell, inputs, n_iter, conv, x, device)
            row = {"seed": seed, "item": k, "n_iter": n_iter, "converged_at": conv, "job_s": lat,
                   "reference_s": time.perf_counter() - t0, "solver": solver, **r}
            out["program"].append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
        del recs
    for seed in args.control_seeds:
        inputs = cell.config_module().reference_inputs(cell.config, cell.shape, seed, 0, device)
        t0 = time.perf_counter()
        n_iter, conv, x = check.control_record(cell, inputs, device)
        t1 = time.perf_counter()
        r = check.readings(cell, inputs, n_iter, conv, x, device)
        row = {"seed": seed, "item": 0, "n_iter": n_iter, "converged_at": conv, "control_s": t1 - t0,
               "reference_s": time.perf_counter() - t1, **r}
        out["control"].append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    summary = {}
    for name in check.NUMBERS:
        prog = [r[name] for r in out["program"]]
        ctrl = [r[name] for r in out["control"]]
        summary[name] = {"program_max": max(prog) if prog else None, "control_min": min(ctrl) if ctrl else None}
    out["summary"] = summary
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
