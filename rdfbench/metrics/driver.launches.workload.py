"""Kernel launches per workload run in the traced window (profiler)."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or not t.kernels or not t.requests:
        return None
    return len(t.kernels) / t.requests
