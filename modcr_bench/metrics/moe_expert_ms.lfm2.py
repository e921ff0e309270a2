"""Device ms a step of the routed experts' grouped products."""

from modcr_bench.metrics._moe import expert_ms


def read(run):
    return expert_ms(run)
