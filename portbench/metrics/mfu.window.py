"""Model step: the FLOPs of the work served in the window, counted by
the program where each result is kept (step meter counters: prompt rows
and keys, generated tokens and their contexts), over the window's
seconds at the H100's 989 TFLOP/s of bf16, in percent."""

from portbench import steps


def read(run):
    return steps.window_mfu(run)
