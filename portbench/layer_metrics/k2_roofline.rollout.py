"""K2's share of its roofline over the traced slice: the least time the
chip could take for the slice's rod-steps (counts/k2.py, with the sweeps
and Newton iterations a rod-step of this cell needs by the reference,
frozen in counts/<workload>.json) over K2's device time by kernel name
(``step_kernel``). The launches come from the program's counter; any the
profiler did not record are taken at the mean of those it did."""
from portbench.counts import k2, peaks


def read(ctx):
    times = ctx.trace.kernel_times("step_kernel") if ctx.trace else []
    n, c = ctx.traced.get("launches", 0), ctx.run.counts
    if not times or not n or "sweeps_per_rod_step" not in c:
        return None
    dims, N = ctx.run.cfg["net"]["dims"], ctx.run.cfg["N"]
    flops = ctx.traced["rod_steps"] * k2.rod_step_flops(
        dims, N, c["sweeps_per_rod_step"], c["iters_per_rod_step"])
    nbytes = n * k2.launch_bytes(dims, N, ctx.run.traffic["rods"])
    device_s = sum(times) * max(n, len(times)) / len(times)
    return 100.0 * peaks.bound_s(flops, nbytes) / device_s
