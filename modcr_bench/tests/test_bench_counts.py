"""Work counts: the kernel ops' bounds reproduce the ones PERF.md's kernel
table was timed against, and the model FLOPs equal what
``torch.utils.flop_counter.FlopCounterMode`` counts on the plain reference
at tiny widths."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from modcr_bench import counts, port, reference, weights
from modcr_bench.reference import model as ref_model
from modcr_bench.reference import params as ref_params
from modcr_bench.tests import tiny
from modcr_bench.traffic import synthetic

BF16 = "c10::BFloat16"


@pytest.mark.parametrize("op, shapes, dtypes, want_ms", [
    ("modcr_torch::spec_attention", [[128, 190, 12, 64]] * 3 + [[128, 190]] * 3 + [[], []],
     [BF16] * 3 + ["float", "int", "float", "", ""], 0.0447),
    ("modcr_torch::dense_attention", [[128, 128, 16, 64], [128, 138, 16, 64],
                                      [128, 138, 16, 64], [128, 1, 1, 138]],
     [BF16] * 3 + ["float"], 0.0417),
    ("modcr_torch::flash_bwd", [[128, 128, 16, 64], [128, 138, 16, 64], [128, 138, 16, 64],
                                [128, 1, 1, 138], [128, 128, 16, 64], []],
     [BF16] * 3 + ["float", BF16, ""], 0.0733),
])
def test_op_bounds_reproduce_the_kernel_table(op, shapes, dtypes, want_ms):
    ms = 1e3 * counts.bound_seconds(*counts.op_work(op, shapes, dtypes))
    assert round(ms, 4) == want_ms


def test_other_ops_have_no_bound():
    assert counts.op_work("aten::mm", [[2, 2], [2, 2]], ["float", "float"]) is None


def _batch(kind, m, questions):
    geo = reference.geometry(kind, m)
    feats, exs = synthetic.make_pool(3, questions, geo, labels=True)
    return reference.tensors(exs, feats, geo, "cpu")


@pytest.mark.parametrize("name", ["modcr_pmr"])
def test_forward_flops_match_the_flop_counter(name):
    conf = tiny.configs()[name]
    kind, m = conf["kind"], conf["model"]
    b = _batch(kind, m, 3)
    P = weights.make(ref_params.SHAPES[kind](m), 1, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref_model.modcr_forward(ref_model.Ref(P), m, b)
    assert counts.MODEL_FLOPS[kind](m, 3) == fc.get_total_flops()


def test_full_size_counts():
    """The published geometry against a hand count (18.7 TFLOP a forward of
    32 questions), to 5%."""
    from modcr_bench import harness

    conf = harness.load_config("modcr_pmr")
    m = port.model_dict(conf, harness.load_cell("pmr_eval_b32"))
    assert abs(counts.modcr_flops(m, 32) / 18.7e12 - 1) < 0.05
