"""The benchmark of ``pycsou_tpu_torch``: one cell of ``BENCHMARK.json``
in one process, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the cell's inputs from the seed,
runs a warm job, measures jobs back to back for ``--seconds``, compares a
sample of their outputs with the plain reference, and prints one JSON
line last: the end-to-end metrics with ``--trace 0``, the per-layer ones
from a profiler trace with ``--trace 1``.  It exits non-zero, with no
result, without enough CUDA cards or when the JAX package is loaded."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the CPU libraries (OpenMP, BLAS), set before they
# load: the card's host is shared, and idle worker threads that spin beside
# the launching thread made the host-bound steps of a job vary from run to
# run.
HOST_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def main(argv=None) -> int:
    os.environ.update(HOST_THREADS)
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench.harness.main import cli

    return cli(argv, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
