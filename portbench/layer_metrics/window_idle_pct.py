"""The device's idle share of the measured window, which runs without the
profiler: 100 (1 - the traced slice's device busy time per launch of the
cell's kernel, by the program's counter, times the window's launches,
over the window's seconds). It stands beside device_idle_pct, whose
slice runs under the profiler, which slows the host."""


def read(ctx):
    t, n = ctx.trace, ctx.traced.get("launches", 0)
    if t is None or not t.ops or not n or not ctx.window.get("launches"):
        return None
    busy = t.busy_s / n * ctx.window["launches"]
    return 100.0 * (1.0 - busy / ctx.window["wall_s"])
