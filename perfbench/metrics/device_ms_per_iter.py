"""``device_ms_per_iter``: the summed durations of the device operations
(kernels, copies, fills) that start inside the ``solve`` spans, over the
iterations."""


def read(ctx):
    if ctx.trace is None:
        return None
    iters = sum(j.n_iter for j in ctx.done)
    ns = sum(e - s for s, e, _, _ in ctx.trace.ops_in("solve"))
    return ns / 1e6 / iters if ns and iters else None
