"""A ModCR-LFM2 scoring batch's model FLOPs (``lfm2_counts.py``) over the
seconds a batch takes outside the traced spans, at the bf16 peak, in %."""

from modcr_bench import counts, lfm2_counts


def read(run):
    t = run.trace
    if t is None or not t.pace_s:
        return None
    flops = lfm2_counts.model_flops(run.model, run.cell["traffic"]["questions_per_batch"])
    return 100.0 * flops / t.pace_s / counts.PEAK_FLOPS
