"""Scheduler and prefix cache: the mean share of the KV pool's blocks
that requests hold (the engine's ``kv_usage``, blocks the prefix cache
keeps but no request holds left out), sampled each second of the
window, in percent."""


def read(run):
    if not run.kv_usage:
        return None
    return 100.0 * sum(run.kv_usage) / len(run.kv_usage)
