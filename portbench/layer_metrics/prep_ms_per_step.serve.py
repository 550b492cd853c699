"""The host work a served step does before K2 can start: from
``serve.step``'s start to its ``k2.launch``'s start (``as_tensor``, the
views, the history terms, the tendon forces), in ms, the mean over the
steps of the program's record of the first traced slice
(portbench/spans.py)."""
from portbench import spans


def read(ctx):
    rec = spans.first_slice(ctx)
    if rec is None:
        return None
    ss = rec[0]
    kids = spans.children(ss, ("k2.launch",))
    gaps = [(kids[i][0].start_ns - ss[i].start_ns) * 1e-6
            for i in spans.named(ss, "serve.step") if i in kids]
    return sum(gaps) / len(gaps) if gaps else None
