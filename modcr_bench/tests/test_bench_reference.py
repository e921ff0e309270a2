"""The plain fp32 reference against the program on the CPU, at tiny widths
in fp32: ModCR's parameter names, the seed's weights, the featurization
and the logits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from modcr_bench import port, reference, weights
from modcr_bench.reference import data as ref_data
from modcr_bench.reference import params as ref_params
from modcr_bench.tests import tiny
from modcr_bench.traffic import synthetic


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_featurize_matches_the_program():
    conf = tiny.configs()["modcr_pmr"]
    geo = reference.geometry("modcr", conf["model"])
    feats, exs = synthetic.make_pool(5, 12, geo, labels=True)
    prog = port.Dataset(exs, feats, geo, memo=False).batch(list(range(12)))
    ref = ref_data.collate(exs, feats, geo)
    assert set(ref) <= set(prog)
    for k, v in ref.items():
        np.testing.assert_array_equal(v, prog[k].astype(v.dtype), err_msg=k)


def test_parameter_names_are_the_programs():
    conf = tiny.configs()["modcr_pmr"]
    m = conf["model"]
    net = port.build_model(conf, m, 3, "cpu")    # strict load: same keys
    shapes = dict(ref_params.SHAPES["modcr"](m))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == shapes


def test_weights_repeat_from_the_seed():
    shapes = ref_params.SHAPES["modcr"](tiny.configs()["modcr_pmr"]["model"])
    a, b = weights.make(shapes, 2**31 + 5, "cpu"), weights.make(shapes, 2**31 + 5, "cpu")
    c = weights.make(shapes, 2**31 + 6, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["abst_confidence_scorer.weight"], c["abst_confidence_scorer.weight"])


def test_logits_match():
    s, stats = tiny.session("pmr_eval_b32", seconds=2.0, check_batches=3)
    assert stats["steps"] >= 3
    assert s.check()["logit_gap"] < 1e-5
