"""``match_ms``: the mean host time of the program's ``pds.match`` spans
(the expression matched onto a fused engine, which the match builds), in
ms.  Nothing to read where the cell builds in set-up."""
from perfbench.harness import program


def read(ctx):
    prog = program.read(ctx)
    spans = prog.named("pds.match") if prog is not None else []
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6 if spans else None
