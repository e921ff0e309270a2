"""Seconds from process start to the first timed step: the build, the
weights, the traffic and the warm-up."""


def read(run):
    return run.setup_s
