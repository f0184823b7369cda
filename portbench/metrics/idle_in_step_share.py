"""Device: the share of the traced span in which no device op ran while
the step thread was inside an ``engine.step`` range and not inside a
``step.wait`` one (host work of the step the device waited for), in
percent. With ``idle_between_steps_share`` and the idle share during
``step.wait`` it adds up to ``device_idle_share``."""

from portbench import steps


def read(run):
    return steps.idle_share(run, "in_step")
