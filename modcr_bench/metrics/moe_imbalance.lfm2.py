"""The busiest expert's tokens over the mean of its layer, averaged over
the MoE layers, from the program's device tally of the window's tokens
per expert (``stats["expert_tokens"]``, counted in traced runs); 1 is an
even spread."""

import statistics


def read(run):
    rows = [r for r in run.stats.get("expert_tokens") or [] if sum(r) > 0]
    if not rows:
        return None
    return statistics.fmean(max(r) * len(r) / sum(r) for r in rows)
