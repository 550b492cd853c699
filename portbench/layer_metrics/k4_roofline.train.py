"""K4's share of its roofline over the traced slice: the least time the
chip could take for the slice's epochs (counts/k4.py: every operation of
an epoch over 67 TFLOP/s, or each launch's bytes once over 3.35 TB/s,
the larger) over K4's device time by kernel name (``train_kernel``). The
launches come from the program's counter; any the profiler did not
record are taken at the mean of those it did."""
from portbench.counts import k4, peaks


def read(ctx):
    times = ctx.trace.kernel_times("train_kernel") if ctx.trace else []
    n = ctx.traced.get("launches", 0)
    if not times or not n:
        return None
    cfg = ctx.run.cfg
    dims = cfg["net"]["dims"]
    C = k4.cells(cfg["data"]["recordings"], cfg["data"]["train_len"],
                 len(cfg["train"]["keypoints"]))
    epochs = ctx.traced["epochs"]
    flops = epochs * k4.epoch_flops(C, dims)
    nbytes = n * k4.launch_bytes(C, dims, epochs / n)
    device_s = sum(times) * max(n, len(times)) / len(times)
    return 100.0 * peaks.bound_s(flops, nbytes) / device_s
