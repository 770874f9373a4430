"""``solve_ms_p90``: the 90th percentile (nearest rank) of every job's
wall time in the window, from its start to ``x`` on the host (host
clock)."""
from perfbench.harness.stats import nearest_rank


def read(ctx):
    lat = [j.latency_s for j in ctx.jobs]
    return 1e3 * nearest_rank(lat, 0.9) if lat else None
