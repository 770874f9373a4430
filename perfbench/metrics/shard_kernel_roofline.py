"""``shard_kernel_roofline``: K14's least time over its device time, in
percent.  Its device time is the summed duration of the trace's
``tv_mega2_shard_kernel`` events (every card's); a launch's least time is
the larger of its bytes at the card's bandwidth and its float32
operations at the card's peak, from the configuration's counts
(``shard_bytes_per_launch``, ``shard_flops_per_launch``: a shard's core
planes once, its share of an iteration's operations; counted low).
Nothing to read without K14 in the trace, on a card with no listed peaks,
or for a configuration without the counts."""

KERNEL = "tv_mega2_shard_kernel"


def read(ctx):
    counts = ctx.counts
    if ctx.trace is None or ctx.peaks is None or not hasattr(counts, "shard_bytes_per_launch"):
        return None
    durations = [e - s for s, e, name, kind in ctx.trace.ops if kind == "kernel" and KERNEL in name]
    if not durations:
        return None
    cfg, shape = ctx.cell.config, ctx.cell.shape
    least = max(counts.shard_bytes_per_launch(cfg, shape) / ctx.peaks["hbm_byte_per_s"],
                counts.shard_flops_per_launch(cfg, shape) / ctx.peaks["f32_flop_per_s"])
    return 100.0 * least * len(durations) / (sum(durations) / 1e9)
