"""The whole rollout step's share of the chip's float32 peak over the
measured window: the frozen operation count of a rod-step (counts/k2.py,
counts/<workload>.json) times the rod-steps done, over the window's
seconds and 67 TFLOP/s."""
from portbench.counts import k2, peaks


def read(ctx):
    c = ctx.run.counts
    if "sweeps_per_rod_step" not in c:
        return None
    flops = ctx.window["rod_steps"] * k2.rod_step_flops(
        ctx.run.cfg["net"]["dims"], ctx.run.cfg["N"],
        c["sweeps_per_rod_step"], c["iters_per_rod_step"])
    return 100.0 * flops / (ctx.window["wall_s"] * peaks.PEAK_F32)
