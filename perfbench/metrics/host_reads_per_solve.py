"""``host_reads_per_solve``: the program's ``solve.host_reads`` counter
(each read in ``solve()`` that waits for the device: a chunk's metric
history, the histories at the finish) over its ``solve`` spans."""
from perfbench.harness import program


def read(ctx):
    return program.per_solve(ctx, lambda p: p.counters.get("solve.host_reads"))
