"""attn_bwd_roofline.train: the training attention kernels' share of their
roofline in the traced stretch: the least time of the forward with its
log-sum-exp and of the backward (its products and bytes counted once,
however the kernels split it) at every attention of a step, at real token
counts (harness/flops.py), times the traced steps, over the device time
of the kernels named "flash_fwd_sm90", "flash_bwd_dkv_sm90" and
"flash_bwd_dq_sm90". Nothing where the trace holds none of them."""

from perfbench.harness.flops import attention_kernel_work, roofline_ms

KERNELS = ("flash_fwd_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90")


def read(run):
    if run.trace is None:
        return None
    spent = sum(run.trace.device_seconds(k) for k in KERNELS)
    if spent <= 0.0:
        return None
    least_ms = sum(count * roofline_ms(*attention_kernel_work(
        kernel, b, nq, nk, h, d))[0]
        for b, nq, nk, h, d, count in run.attention_calls
        for kernel in ("fwd_lse", "bwd"))
    return 100.0 * least_ms * 1e-3 * run.trace.calls / spent
