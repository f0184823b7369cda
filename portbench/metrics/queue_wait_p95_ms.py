"""Front and admission: 95th percentile of the wait from when a request
was due to when the engine admitted it (``RequestMetrics.admitted_time``),
over every request due in the window. One not admitted by the close
waits until the close; the engine's record of a request that had no
output yet is read at the close."""

from portbench import stats


def read(run):
    waits = []
    for r in run.requests:
        if not run.t_open <= r.due_s < run.t_close:
            continue
        m = r.metrics
        end = run.t_close
        if m is not None and m.admitted_time is not None:
            end = min(end, run.perf(m.admitted_time))
        waits.append(max(0.0, end - r.due_s))
    p = stats.percentile(waits, 95)
    return None if p is None else p * 1e3
