"""``setup_s``: process start to the first timed job: imports, the card's
start, the kernel library, the inputs and the program's objects, and one
warm job (host clock)."""


def read(ctx):
    return ctx.setup_s
