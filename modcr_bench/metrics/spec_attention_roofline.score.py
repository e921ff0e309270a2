"""Bound over device time under modcr_torch::spec_attention, in %."""

from modcr_bench.metrics._lib import roofline


def read(run):
    return roofline(run, "spec_attention")
