"""Seconds the port takes to build its TripleStore (dedupe and six
sorted indexes) from the triples (host clock, set-up)."""


def read(ctx):
    return ctx.steps.get("store.build_s")
