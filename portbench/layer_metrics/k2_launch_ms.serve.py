"""K2's wrapper on the host, ``k2.launch`` (``make_step_kernel``'s
``fn``: the argument checks, the outputs' ``empty`` calls, the weights'
and net table's arguments and the ctypes call), in ms, the mean over the
launches of the program's record of the first traced slice
(portbench/spans.py)."""
from portbench import spans


def read(ctx):
    rec = spans.first_slice(ctx)
    if rec is None:
        return None
    ks = [spans.length_ms(rec[0][i]) for i in spans.named(rec[0],
                                                          "k2.launch")]
    return sum(ks) / len(ks) if ks else None
