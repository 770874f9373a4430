"""Whether NCCL carries the port's exchanges between two processes on one
card.

    python tools/nccl_probe.py

Starts two processes on ``cuda:0`` joined by
``parallel.distributed_init(..., backend="nccl")``; each sends a CUDA
tensor to the other through ``parallel.mesh.transfer`` (the halo
exchanges' ``batch_isend_irecv``) and folds one term a position with
``parallel.mesh.fold``.  It prints, for each process, ``OK`` with what it
received, or the error it raised (NCCL refuses two ranks on one device in
one communicator), or that it did not finish within the timeout, in which
case both are killed.  It exits 0 in every case: the answer is what it
prints.  The two-process path on one card is otherwise ``backend="gloo"``
(``chip_smoke.py`` phase 16).
"""
from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

_TIMEOUT = 90

_WORKER = r"""
import sys

import torch

from pycsou_tpu_torch.parallel import Mesh, distributed_init
from pycsou_tpu_torch.parallel.mesh import fold, transfer

coord, rank = sys.argv[1], int(sys.argv[2])
torch.cuda.set_device(0)
distributed_init(coordinator_address=coord, num_processes=2, process_id=rank, backend="nccl")
dev = torch.device("cuda", 0)
mine = torch.full((4, 8), float(rank + 1), device=dev)
like = torch.empty(4, 8, device=dev)
msgs = [(0, 0, 1, mine if rank == 0 else None, like), (1, 1, 0, mine if rank == 1 else None, like)]
got = [g for g in transfer(msgs) if g is not None][0]
mesh = Mesh([dev] * 2, ("sp",), ranks=(0, 1))
total = fold(mesh.place([torch.tensor(float(rank + 1), device=dev)]))
torch.cuda.synchronize()
print(f"OK received {float(got[0, 0])}, fold {float(total)}", flush=True)
torch.distributed.destroy_process_group()
"""


def main() -> int:
    root = Path(__file__).resolve().parent.parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(r)], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            print(f"process {r}: did not finish within {_TIMEOUT} s (both killed)")
            return 0
        lines = [ln for ln in out.splitlines() if ln.strip()]
        ok = [ln for ln in lines if ln.startswith("OK")]
        errors = [ln for ln in lines if "Error" in ln or "error" in ln]
        print(f"process {r}: exit {p.returncode}: " + (ok[0] if ok else " | ".join(errors[-3:]) or "\n".join(lines[-5:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
