"""End to end: 95th percentile of the time to first token over every
request whose first token came in the window, each timed from when it
was due, not from when it was sent (host clock)."""

from portbench import stats


def read(run):
    p = stats.percentile(stats.ttfts(run.requests, run.t_open,
                                     run.t_close), 95)
    return None if p is None else p * 1e3
