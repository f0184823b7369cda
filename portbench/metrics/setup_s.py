"""End to end: seconds from the process's start to the window's opening:
CUDA start, weights, the engine's boot and KV sizing, the kernel build
of a fresh checkout, the warm-up and the traffic's ramp (host clock)."""


def read(run):
    return run.setup_s
