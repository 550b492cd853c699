"""The device's idle share of the traced slice: 100 (1 - the union of the
device operations' intervals over the slice's length)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * t.idle_share()
