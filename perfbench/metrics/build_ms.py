"""``build_ms``: the mean ``build`` span (the ``PDS(...)`` construction,
ended after the device's queue drains), from the trace.  Nothing to read
where the cell builds in set-up."""


def read(ctx):
    spans = ctx.trace.spans.get("build", []) if ctx.trace is not None else []
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e6
