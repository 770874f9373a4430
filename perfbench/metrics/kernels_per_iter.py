"""``kernels_per_iter``: the kernels that start inside the ``solve`` spans
(the profiler's device events, whatever launched them) over the
iterations."""


def read(ctx):
    if ctx.trace is None:
        return None
    iters = sum(j.n_iter for j in ctx.done)
    n = len(ctx.trace.ops_in("solve", kinds=("kernel",)))
    return n / iters if n and iters else None
