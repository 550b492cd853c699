"""What an RK4 rollout step costs beyond K2, as
``host_ms_per_step.rollout`` reads it: the window's seconds a time step
minus K2's mean device time a launch, in ms."""
from portbench.harness import reader_of

read = reader_of("host_ms_per_step.rollout")
