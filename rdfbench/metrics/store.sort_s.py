"""Seconds of the six lexsorts and fused keys of the port's TripleStore
at set-up: its `store.sort` phase (`repro_torch.trace`)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:     # a program without the port's phases
        return None
    p = trace.phases().get("store.sort")
    return None if p is None else p.seconds
