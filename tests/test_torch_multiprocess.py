"""``distributed_init`` of the port across two real processes (the twin of
``tests/test_multiprocess.py``).

Two worker processes, which import only ``torch``, numpy and the port, join
one ``torch.distributed`` group over ``gloo`` at ``tcp://127.0.0.1:<free
port>``; ``make_mesh((4,), devices=["cpu"] * 2)`` then spans both, two
positions a process.  In each process: ``psum`` of the sums of the local
blocks of ``arange(8.0)`` is 28.0, ``pdot`` of two sharded vectors equals
numpy's dot within rtol 1e-5, ``distributed_init`` of one process is a
no-op, the mesh's backend is gloo (the default for CPU tensors, with or
without a card), and a sharded solver and two sharded operators given the
mesh run across both processes: each process gets the whole result, within
1e-5 of the same call on a one-process mesh (and of numpy for the dense
operator).  ``tests/test_torch_multiprocess_solvers.py`` holds every
sharded solver and operator across processes bit for bit to the
one-process mesh.  It skips only where the host cannot open a
localhost socket.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys

import numpy as np
import torch

from pycsou_tpu_torch.parallel import (
    DistributedTVDeconv2D, Mesh, NamedSharding, PartitionSpec, PencilCircularConv2D, ShardedDenseOperator,
    distributed_init, make_mesh, pdot, psum,
)

coord, pid = sys.argv[1], int(sys.argv[2])
distributed_init()  # one process: nothing to join
assert not torch.distributed.is_initialized()
distributed_init(coordinator_address=coord, num_processes=2, process_id=pid)
assert torch.distributed.get_world_size() == 2
mesh = make_mesh((4,), ("d",), devices=["cpu"] * 2)
assert mesh.backend == "gloo", mesh.backend
assert mesh.size == 4 and mesh.spans_processes and mesh.ranks == (0, 0, 1, 1)
assert mesh.process_index == pid and mesh.local_positions == (2 * pid, 2 * pid + 1)
sh = NamedSharding(mesh, PartitionSpec("d"))
blocks = sh.split(torch.arange(8.0))
assert [b.tolist() for b in blocks] == [[4.0 * pid, 4.0 * pid + 1], [4.0 * pid + 2, 4.0 * pid + 3]]
total = psum([b.sum() for b in blocks], mesh)
assert float(total) == 28.0, float(total)
rng = np.random.default_rng(5)
a, b = rng.standard_normal(64), rng.standard_normal(64)
got = float(pdot(sh.split(torch.from_numpy(a)), sh.split(torch.from_numpy(b)), mesh=mesh))
assert abs(got - float(a @ b)) <= 1e-5 * abs(float(a @ b)), (got, float(a @ b))
local = Mesh(["cpu"] * 4, ("sp",))  # the same four positions in this process alone
y = np.abs(rng.standard_normal((32, 16))).astype(np.float32)
x_two, z_two = DistributedTVDeconv2D((32, 16), np.ones((1, 1), np.float32), y, 0.1, use_pallas=False,
                                     mesh=make_mesh((4,), devices=["cpu"] * 2)).run(3)
x_one, z_one = DistributedTVDeconv2D((32, 16), np.ones((1, 1), np.float32), y, 0.1, use_pallas=False,
                                     mesh=local).run(3)
assert x_two.shape == (32, 16) and z_two.shape == (2, 32, 16)
assert float((x_two - x_one).abs().max()) <= 1e-5 and float((z_two - z_one).abs().max()) <= 1e-5
M = rng.standard_normal((8, 8)).astype(np.float32)
v = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
Mv = ShardedDenseOperator(M, mesh=make_mesh((4,), devices=["cpu"] * 2)).apply(v)
assert float((Mv - torch.from_numpy(M) @ v).abs().max()) <= 1e-5
img = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
filt = np.full((3, 3), 1.0 / 9.0)
got = PencilCircularConv2D((8, 8), filt, mesh=make_mesh((4,), devices=["cpu"] * 2)).apply(img)
want = PencilCircularConv2D((8, 8), filt, mesh=local).apply(img)
assert float((got - want).abs().max()) <= 1e-5
torch.distributed.destroy_process_group()
print(f"proc {pid} OK", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum(tmp_path):
    try:
        coord = f"127.0.0.1:{_free_port()}"
    except OSError as e:
        pytest.skip(f"no localhost socket on this host: {e}")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [str(_ROOT), env.get("PYTHONPATH", "")] if p)
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen([sys.executable, str(script), coord, str(i)], env=env, cwd=str(tmp_path),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    joined = "\n".join(outs)
    if any(p.returncode != 0 for p in procs):
        if "Address family not supported" in joined or "Permission denied" in joined and "socket" in joined:
            pytest.skip(f"no localhost socket on this host:\n{joined[-500:]}")
        raise AssertionError(f"worker failed:\n{joined}")
    assert all("OK" in o for o in outs)
