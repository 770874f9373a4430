"""``images_per_s``: jobs completed over the whole window (host clock)."""


def read(ctx):
    return len(ctx.done) / ctx.window.window_s if ctx.window.window_s > 0 else None
