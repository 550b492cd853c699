"""K2's Newton iterations a rod-step: the program's counters
``k2.newton_iters`` (each launch's returned ``iters``, summed) over
``k2.rod_steps`` (each launch's rods) in the first traced slice
(portbench/spans.py). One reader serves ``.rollout`` and ``.serve``."""
from portbench import spans


def read(ctx):
    iters = spans.counter(ctx, "k2.newton_iters")
    steps = spans.counter(ctx, "k2.rod_steps")
    return iters / steps if iters is not None and steps else None
