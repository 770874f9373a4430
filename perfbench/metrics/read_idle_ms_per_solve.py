"""``read_idle_ms_per_solve``: the device's idle time whose gaps start while
the innermost program span open on the host is ``solve.read`` (the chunk
read's turnaround: the host waits for the copy, then launches the next
chunk), in ms over the ``solve`` spans."""
from perfbench.harness import program


def read(ctx):
    return program.idle_ms_per_solve(ctx, ("solve.read",))
