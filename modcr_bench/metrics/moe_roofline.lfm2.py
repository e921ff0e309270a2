"""The routed experts' products: their bound (FLOPs at the bf16 rate, or
bytes at the HBM rate, per MoE layer) over their device time, in %."""

from modcr_bench.metrics._moe import roofline_pct


def read(run):
    return roofline_pct(run)
