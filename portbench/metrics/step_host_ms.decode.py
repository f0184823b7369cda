"""Step loop: host milliseconds a step whose round was a decode round,
over the window: the step meter's wall seconds less its seconds in the
device->host seam, over its steps of that kind."""

from portbench import steps


def read(run):
    return steps.ms_per_step(run, "step_host_seconds_by_kind", "decode")
