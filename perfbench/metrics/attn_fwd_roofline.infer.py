"""attn_fwd_roofline.infer: the attention forward kernel's share of its
roofline in the traced stretch: the least time its work needs at every
attention of a call, at real token counts (harness/flops.py), times the
traced calls, over the device time of the kernels named
"flash_fwd_sm90". Nothing where the trace holds no such kernel."""

from perfbench.harness.flops import attention_kernel_work, roofline_ms

KERNEL = "flash_fwd_sm90"


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.device_seconds(KERNEL)
    if spent <= 0.0:
        return None
    least_ms = sum(count * roofline_ms(*attention_kernel_work(
        "fwd", b, nq, nk, h, d))[0]
        for b, nq, nk, h, d, count in run.attention_calls)
    return 100.0 * least_ms * 1e-3 * run.trace.calls / spent
