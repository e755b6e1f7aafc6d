"""Program rebuilds over the window: the adaptive driver's `recompiles`
plus `bucket_compiles` (WorkloadExecutor.telemetry(), after - before)."""


def read(ctx):
    if ctx.kind != "workload":
        return None
    return ctx.telemetry["recompiles"] + ctx.telemetry["bucket_compiles"]
