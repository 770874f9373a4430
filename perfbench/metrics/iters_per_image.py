"""``iters_per_image``: the mean ``SolveInfo.n_iter`` of the window's
completed jobs."""


def read(ctx):
    done = ctx.done
    return sum(j.n_iter for j in done) / len(done) if done else None
