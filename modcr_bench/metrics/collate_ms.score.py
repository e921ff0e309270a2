"""Host ms the loader's producer thread takes to assemble a window's batch
(the program's ``data.batch`` span)."""

from modcr_bench.metrics._spans import window_mean_ms


def read(run):
    return window_mean_ms(run, "data.batch")
