"""``halo_ms_per_iter``: the device time of the copies between cards
(``Memcpy PtoP`` events) in the stretch of each solve where its steps run,
summed over the cards, over the window's iterations.

The stretch runs from a solve's first ``solve.enqueue`` span to the end of
its last ``solve.read`` (the program's spans): the host launches each chunk
ahead of the device and waits in ``solve.read`` for its last step, so the
device's steps fall inside it, and the join of ``x`` in ``solve.finish``
falls outside.  A copy cannot be put down to the ``sp.halo`` span that
launched it by the host clock (the device runs it later, and the trace
keeps no correlation), so copies are told by their kind: in the sharded
step they are the halo exchange's, and the stats fold's three 24-byte
copies an iteration.  Nothing to read without the program's ``sp.halo``
spans (a program with no sharded step, or one older than its spans)."""
from perfbench.harness import program

KIND = "PtoP"


def read(ctx):
    prog = program.read(ctx)
    if prog is None or ctx.trace is None or not prog.named("sp.halo"):
        return None
    stretches = {}
    for s in prog.spans:
        if s.name in ("solve.enqueue", "solve.read"):
            lo, hi = stretches.get(s.request, (s.start_ns, s.end_ns))
            stretches[s.request] = (min(lo, s.start_ns), max(hi, s.end_ns))
    iters = sum(j.n_iter for j in ctx.done)
    ns = sum(e - s for s, e, name, kind in ctx.trace.ops
             if kind == "gpu_memcpy" and KIND in name and any(lo <= s < hi for lo, hi in stretches.values()))
    return ns / 1e6 / iters if iters and stretches else None
