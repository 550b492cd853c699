"""The BDF-2 glue of a rollout step: ``rollout.step`` less its
``k2.launch`` (the history terms, the tendon forces, the extrapolated
guess, the records), in ms a step, from the program's record of the first
traced slice (portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_parent_ms(ctx, "rollout.step", ("k2.launch",),
                               exclusive=True)
