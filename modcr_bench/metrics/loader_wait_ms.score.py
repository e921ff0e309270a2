"""Host ms per step that the loop waits for the loader's next batch."""

from modcr_bench.metrics._lib import loader_wait_ms


def read(run):
    return loader_wait_ms(run)
