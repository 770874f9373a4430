"""``enqueue_us_per_iter``: the host time of the program's ``solve.enqueue``
spans (a chunk's steps launched, one span a chunk) over the window's
iterations, in microseconds: the host's cost of the launches, beside the
device's ``device_ms_per_iter``."""
from perfbench.harness import program


def read(ctx):
    prog = program.read(ctx)
    iters = sum(j.n_iter for j in ctx.done)
    ns = prog.total_ns("solve.enqueue") if prog is not None else 0
    return ns / 1e3 / iters if ns and iters else None
