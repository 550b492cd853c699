"""The cells' physics that train_knode recomputes every K4 chunk
(``make_run``'s ``precompute``, the program's ``k4.cells`` span), in ms a
chunk (``train.chunk``), from the program's record of the first traced
slice (portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_parent_ms(ctx, "train.chunk", ("k4.cells",))
