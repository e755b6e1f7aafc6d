"""Process start to the first timed request: data, the port's
TripleStore, retune(), apply() and warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
