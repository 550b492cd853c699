"""What a served step costs beyond K2: the measured window's mean step
latency (host clock, call to synchronise) minus K2's mean device time a
launch in the traced slice, in ms: CompiledStepper.step's Python, the
history terms, the launch and the synchronise."""


def read(ctx):
    times = ctx.trace.kernel_times("step_kernel") if ctx.trace else []
    if not times:
        return None
    lat = ctx.window["lat"]
    return 1e3 * (sum(lat) / len(lat) - sum(times) / len(times))
