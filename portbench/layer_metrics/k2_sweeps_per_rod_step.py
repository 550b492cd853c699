"""K2's sweeps a rod-step: the program's counters ``k2.sweeps`` (each
launch's rods' sweep counts, summed: the first residual, the probes, the
line-search candidates K2 ran and the recording sweep) over
``k2.rod_steps`` in the first traced slice (portbench/spans.py), beside
the reference's frozen count (counts/<workload>.json). A program without
the counter reads None."""
from portbench import spans


def read(ctx):
    sweeps = spans.counter(ctx, "k2.sweeps")
    steps = spans.counter(ctx, "k2.rod_steps")
    return sweeps / steps if sweeps is not None and steps else None
