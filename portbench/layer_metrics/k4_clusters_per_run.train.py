"""The clusters a K4 run spreads its cells over: the program's counter
``k4.clusters`` (each launch's clusters a run) over the slice's
``k4.launch`` spans. A program without the counter reads None."""
from portbench import spans


def read(ctx):
    total = spans.counter(ctx, "k4.clusters")
    rec = spans.first_slice(ctx)
    launches = len(spans.named(rec[0], "k4.launch")) if rec else 0
    return total / launches if total is not None and launches else None
