"""The rest of a K4 chunk: ``train.chunk`` less its ``k4.cells``,
``k4.launch`` and ``train.wait`` spans, in ms a chunk: the round trip of
the weights and the optimizer state between chunks and the loop's Python,
from the program's record of the first traced slice (portbench/spans.py).
With cells_ms_per_chunk, wait_ms_per_chunk and K4's launch it partitions
the chunk."""
from portbench import spans


def read(ctx):
    return spans.per_parent_ms(ctx, "train.chunk",
                               ("k4.cells", "k4.launch", "train.wait"),
                               exclusive=True)
