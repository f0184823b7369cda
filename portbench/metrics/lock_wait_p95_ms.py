"""Front and admission: 95th percentile of the seconds
``AsyncLLMEngine.generate`` waited for the engine's lock before adding
the request (``RequestMetrics.lock_wait_s``), over every request due in
the window. One with no record by the close counts from when it was
sent to the close. The part of ``queue_wait_p95_ms`` a front that
queues without the lock would remove."""

from portbench import stats, steps


def read(run):
    waits = steps.lock_waits(run)
    p = stats.percentile(waits or [], 95)
    return None if p is None else p * 1e3
