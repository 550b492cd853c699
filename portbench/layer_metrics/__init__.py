"""One reader per per-layer metric, ``<metric>.py`` with ``read(ctx)``: the
metric's value from the traced slice (``ctx.trace``, a trace.Trace), the
host clock's facts of the measured window (``ctx.window``) and of the
traced slice (``ctx.traced``), the cell's files and frozen counts
(``ctx.run``); None where it finds nothing to read."""
