"""Host ms a window's step waits on the loader's queue (the program's
``data.wait`` span), the loader's own view of ``loader_wait_ms``."""

from modcr_bench.metrics._spans import window_mean_ms


def read(run):
    return window_mean_ms(run, "data.wait")
