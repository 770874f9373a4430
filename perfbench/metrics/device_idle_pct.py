"""``device_idle_pct``: the share of the traced window in which no
operation ran on the device (the union of the device events' intervals,
both from the same trace)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.trace.window_s) if busy > 0 else None
