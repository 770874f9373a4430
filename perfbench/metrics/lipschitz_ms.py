"""``lipschitz_ms``: the host time of the program's ``conv.lipschitz`` spans
(the FFT bound on a convolution's norm) over its ``pds.init`` spans (the
``PDS(...)`` constructions), in ms.  Nothing to read where the cell builds
in set-up."""
from perfbench.harness import program


def read(ctx):
    prog = program.read(ctx)
    n = len(prog.named("pds.init")) if prog is not None else 0
    return prog.total_ns("conv.lipschitz") / 1e6 / n if n else None
