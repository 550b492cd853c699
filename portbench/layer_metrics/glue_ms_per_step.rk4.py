"""The BDF-2 glue of an RK4 rollout step, as ``glue_ms_per_step.rollout``
reads it: ``rollout.step`` less its ``k2.launch``, in ms a step."""
from portbench.harness import reader_of

read = reader_of("glue_ms_per_step.rollout")
