"""mfu.train: the share of the card's bf16 dense peak that the untraced
window's training steps reached: three times the forward's products a
step (the configuration's reference count; recomputation not counted)
times the steps, over the window's seconds."""

from perfbench.harness.flops import H100_SXM_BF16_DENSE_PEAK_FLOPS


def read(run):
    flops = run.flops_per_call * len(run.latencies)
    return 100.0 * flops / run.window_s / H100_SXM_BF16_DENSE_PEAK_FLOPS
