"""The first parallel vector-math call of a process on the CPU.

ATen runs ``torch.sqrt`` (and ``log``, ``cos``, ``abs``) on a float tensor
through MKL's vector math (VML), one chunk of the tensor to each OpenMP
thread.  In a process whose OpenMP threads are already up, the first such
call can race MKL's choice of code path, and one thread's chunk then comes
out of a low-accuracy square root.  Importing ``pycsou_tpu_torch`` makes
one first call on one thread (``utils.device.settle_cpu_math``).

Each case below starts fresh processes that bring up the OpenMP threads
with a parallel ``add``, then run K16's plain version (whose dual
projection takes a square root) twice on the same inputs and report
whether the two results differ.  Run as a script to count both ways:

    python tests/test_torch_cpu_math.py --procs 30             # settled
    python tests/test_torch_cpu_math.py --procs 30 --unsettled

``--unsettled`` loads the package's modules without running its
``__init__``, so that nothing settles before the plain route.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os, sys, types
import numpy as np, torch
root, settled = sys.argv[1], sys.argv[2] == "1"
sys.path.insert(0, root)
if not settled:
    pkg = types.ModuleType("pycsou_tpu_torch")
    pkg.__path__ = [os.path.join(root, "pycsou_tpu_torch")]
    sys.modules["pycsou_tpu_torch"] = pkg
from pycsou_tpu_torch.kernels.tv import tv_pds_sweep_shard_step_plain
a = torch.ones(1 << 20)
(a + a).sum()
H, W = 256, 512
rng = np.random.default_rng(0)
t = lambda v: torch.from_numpy(v.astype(np.float32))
x, g = t(np.abs(rng.standard_normal((H, W)))), t(rng.standard_normal((H, W)))
z0, z1 = t(0.01 * rng.standard_normal((H, W))), t(0.01 * rng.standard_normal((H, W)))
halos = tuple(torch.zeros(1, W) for _ in range(8))
kw = dict(H_global=H, tau=0.3, sigma=0.3, rho=0.9, lam=0.05, iso=True, nonneg=True)
first = tv_pds_sweep_shard_step_plain(x, g, z0, z1, halos, -1, **kw)
second = tv_pds_sweep_shard_step_plain(x, g, z0, z1, halos, -1, **kw)
print(max(float((u - v).abs().max()) for u, v in zip(first, second)))
"""


def run(procs: int, settled: bool) -> list:
    """The largest difference between the two results, one a process."""
    out = []
    for _ in range(procs):
        res = subprocess.run([sys.executable, "-c", _CHILD, _ROOT, "1" if settled else "0"],
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        out.append(float(res.stdout.split()[-1]))
    return out


def test_settled_plain_route_is_steady():
    diffs = run(6, settled=True)
    assert diffs == [0.0] * 6, f"K16's plain version moved between two calls in a fresh process: {diffs}"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=30)
    ap.add_argument("--unsettled", action="store_true")
    args = ap.parse_args()
    diffs = run(args.procs, settled=not args.unsettled)
    moved = [d for d in diffs if d != 0.0]
    print(f"{'unsettled' if args.unsettled else 'settled'}: {len(moved)} of {args.procs} processes moved; "
          f"largest difference {max(diffs):.3e}")
