"""The share of the traced window in which no operation ran on the
device, in %: 1 - (union of device activity / window) (profiler)."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
