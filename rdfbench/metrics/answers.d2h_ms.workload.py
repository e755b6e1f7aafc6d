"""Device time of the device-to-host copies per workload run in the
traced window, in ms (profiler): the answers brought to the host."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or not t.requests or t.d2h_us <= 0:
        return None
    return t.d2h_us / 1e3 / t.requests
