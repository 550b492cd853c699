"""What a K4 chunk costs beyond K4 itself: the measured window's seconds
per K4 launch (the program's counter) minus K4's mean device time a
launch in the traced slice, in ms. It holds train_knode's loop: the fused
state's round trip, the weight copies, the losses read back, and each
call's own set-up."""


def read(ctx):
    times = ctx.trace.kernel_times("train_kernel") if ctx.trace else []
    w = ctx.window
    if not times or not w.get("launches"):
        return None
    return 1e3 * (w["wall_s"] / w["launches"] - sum(times) / len(times))
