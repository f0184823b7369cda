"""Kernels: the attention bound of the work the requests needed in the
traced span (roofline.served_work, chip_smoke's bound), over the device
seconds of the port's three attention kernels there, in percent."""

from portbench import roofline

# the port's attention kernels (csrc/paged_attention.cu,
# csrc/paged_prefill.cu, csrc/paged_decode.cu)
KERNELS = ("ragged_tile_kernel", "prefill_kernel", "decode_split_kernel",
           "decode_merge_kernel")


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spent = t.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    work = roofline.served_work(run.shape, run.requests, t.perf0, t.perf1)
    return 100.0 * work.attn_bound_s / spent
