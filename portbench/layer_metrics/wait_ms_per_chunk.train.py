"""The host's reads of the device in a K4 chunk (the program's
``train.wait`` spans: the fused state's scalars through ``.tolist()`` and
the losses through ``.cpu()``, where the host waits for K4), in ms a chunk
(``train.chunk``), from the program's record of the first traced slice
(portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_parent_ms(ctx, "train.chunk", ("train.wait",))
