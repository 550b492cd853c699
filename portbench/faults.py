"""Faults planted in the program, for the readings that show the check
catches them (``calibrate.py --kinds``) and for the benchmark's own tests.

``copy_back_dropped``: train_knode keeps the net it started a K4 chunk
from, so every chunk trains the initial weights again (a state returned
unchanged). ``carry_dropped``: the kernel's optimizer state is not poured
back between chunks, so every chunk starts Adam and the plateau afresh.
"""
from __future__ import annotations

import contextlib
import copy

PLANTED = ("copy_back_dropped", "carry_dropped")


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` planted, restored on exit."""
    from knode_cosserat_tpu_torch.ops import train as OT

    if name == "copy_back_dropped":
        attr, orig = "make_fused_training_run", OT.make_fused_training_run

        def broken(*a, **k):
            run = orig(*a, **k)

            def dropped(net, *b):
                _, losses, state = run(net, *b)
                return copy.deepcopy(net), losses, state
            return dropped
    elif name == "carry_dropped":
        attr, orig = "load_fused_state", OT.load_fused_state

        def broken(opt, state):
            return opt
    else:
        raise ValueError(f"no planted fault {name!r}; {PLANTED}")
    setattr(OT, attr, broken)
    try:
        yield
    finally:
        setattr(OT, attr, orig)
