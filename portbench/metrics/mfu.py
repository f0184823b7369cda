"""Model step: the FLOPs of the work the requests needed in the traced
span (roofline.served_work: each delivery's work spread over the time
since the request's previous one), over the span's seconds at the
H100's 989 TFLOP/s of bf16, in percent."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    work = roofline.served_work(run.shape, run.requests, t.perf0, t.perf1)
    if work.flops <= 0:
        return None
    return 100.0 * work.flops / (t.span_s * roofline.BF16_FLOPS)
