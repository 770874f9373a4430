"""``solve_iters_per_s``: all iterations of the traced window over the
summed ``solve`` spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    secs = ctx.trace.span_seconds("solve")
    iters = sum(j.n_iter for j in ctx.done)
    return iters / secs if secs > 0 and iters > 0 else None
