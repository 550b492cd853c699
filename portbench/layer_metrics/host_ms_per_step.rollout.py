"""What a rollout step costs beyond K2: the measured window's seconds per
time step (calls x (T - 1)) minus K2's mean device time a launch in the
traced slice, in ms: the BDF-2 history terms, the tendon forces, the
records and the launch."""


def read(ctx):
    times = ctx.trace.kernel_times("step_kernel") if ctx.trace else []
    if not times:
        return None
    w = ctx.window
    steps = w["calls"] * (ctx.run.traffic["steps"] - 1)
    return 1e3 * (w["wall_s"] / steps - sum(times) / len(times))
