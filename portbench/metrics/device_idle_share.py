"""Device: the share of the traced span in which no kernel, copy or set
ran on any stream (one minus the union of device intervals over the
span), in percent."""


def read(run):
    if run.trace is None or run.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.span_s)
