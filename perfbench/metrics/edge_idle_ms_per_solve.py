"""``edge_idle_ms_per_solve``: the device's idle time whose gaps start while
the innermost program span open on the host is ``solve.start`` (the state
and history fills) or ``solve.finish`` (the histories read,
``postprocess``), in ms over the ``solve`` spans."""
from perfbench.harness import program


def read(ctx):
    return program.idle_ms_per_solve(ctx, ("solve.start", "solve.finish"))
