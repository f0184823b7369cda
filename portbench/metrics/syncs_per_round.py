"""Step loop: device->host fetches (the engine's ``_to_numpy`` seam)
a step whose round was not idle, over the window (step meter
counters)."""

from portbench import steps


def read(run):
    return steps.syncs_per_round(run)
