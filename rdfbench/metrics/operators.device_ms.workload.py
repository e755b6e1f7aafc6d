"""Device kernel time per request in the traced window, in ms (profiler;
copies and sets left out)."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or not t.kernels or not t.requests:
        return None
    return sum(k[2] for k in t.kernels) / 1e3 / t.requests
