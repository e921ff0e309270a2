"""A scoring batch's model FLOPs over its seconds outside the traced spans,
at the bf16 peak, in %."""

from modcr_bench.metrics._lib import mfu


def read(run):
    return mfu(run)
