"""``step_roofline``: the least time of the traced window's iterations
over their device time, in percent.  A job's least time is the larger of
its iterations' float32 operations at the card's peak and its solve's own
bytes (inputs read once, ``x`` written once) at the card's bandwidth; the
counts are the configuration's (``flops_per_iter``, ``bytes_per_solve``),
counted low.  Nothing to read on a card with no listed peaks."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    cfg, shape = ctx.cell.config, ctx.cell.shape
    flops = ctx.counts.flops_per_iter(cfg, shape)
    nbytes = ctx.counts.bytes_per_solve(cfg, shape)
    least = sum(max(j.n_iter * flops / ctx.peaks["f32_flop_per_s"], nbytes / ctx.peaks["hbm_byte_per_s"])
                for j in ctx.done)
    ns = sum(e - s for s, e, _, _ in ctx.trace.ops_in("solve"))
    return 100.0 * least / (ns / 1e9) if ns and least else None
