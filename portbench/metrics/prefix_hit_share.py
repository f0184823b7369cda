"""Scheduler and prefix cache: prompt tokens the prefix cache served, as
a share of the prompt tokens admitted in the window (the engine's
``prefix_cache_hits`` / ``prefix_cache_queries`` deltas), in percent."""


def read(run):
    q = run.after.prefix_cache_queries - run.before.prefix_cache_queries
    if q <= 0:
        return None
    h = run.after.prefix_cache_hits - run.before.prefix_cache_hits
    return 100.0 * h / q
