"""Seconds of `TuningSession.apply()`: the host materialization of the
views, their upload, the TT upload and the warm run (host clock, set-up)."""


def read(ctx):
    return ctx.steps.get("session.apply_s")
