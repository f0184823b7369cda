"""Device: the share of the traced span in which no device op ran and
the step thread was inside no ``engine.step`` range (waiting for the
engine's lock or for work, or outside the loop), in percent."""

from portbench import steps


def read(run):
    return steps.idle_share(run, "between")
