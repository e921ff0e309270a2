"""Host ms of a window's eval step (the program's ``step.eval`` span): the
enqueue of the forward, unless something in it blocks."""

from modcr_bench.metrics._spans import window_mean_ms


def read(run):
    return window_mean_ms(run, "step.eval")
