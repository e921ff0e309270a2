"""Share of the traced span in which no kernel ran, in %."""

from modcr_bench.metrics._lib import idle_pct


def read(run):
    return idle_pct(run)
