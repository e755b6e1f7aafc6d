"""Seconds the port takes to materialize the chosen views at set-up
(evaluation, measured statistics, the extents' uploads): its
`views.materialize` phase inside `apply()` (`repro_torch.trace`)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:     # a program without the port's phases
        return None
    p = trace.phases().get("views.materialize")
    return None if p is None else p.seconds
