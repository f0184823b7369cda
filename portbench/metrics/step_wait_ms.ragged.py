"""Step loop: milliseconds a step whose round was ragged spent in the
device->host seam (the engine's ``_to_numpy``: the copy and the wait
for the device), over the window (step meter counters)."""

from portbench import steps


def read(run):
    return steps.ms_per_step(run, "step_wait_seconds_by_kind", "ragged")
