"""``conv_reuse_share``: the program's ``pds.conv_reused`` counter (a fused
engine took the user's ``Convolve2D`` as it is, with no second build) over
its ``pds.init`` spans (the ``PDS(...)`` constructions).  0 where the
engines build their convolution again; nothing to read where the cell
builds in set-up, or from a program without the counter's spans."""
from perfbench.harness import program


def read(ctx):
    prog = program.read(ctx)
    n = len(prog.named("pds.init")) if prog is not None else 0
    return prog.counters.get("pds.conv_reused", 0) / n if n else None
