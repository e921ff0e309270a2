"""Questions scored (x num_labels candidates each) over the whole window."""

from modcr_bench.metrics._lib import per_second


def read(run):
    return per_second(run, "score_examples")
