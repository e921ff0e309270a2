"""The frozen traffic generator: one seed gives the same requests twice,
two seeds differ, every seed gives the same batch geometry, and it draws
what the program's own ``serving/synthetic.py`` draws."""

from __future__ import annotations

import dataclasses

import numpy as np

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.serving import synthetic as program_synthetic

from modcr_bench import port, reference
from modcr_bench.tests import tiny
from modcr_bench.traffic import synthetic

GEO = dict(img_len=50, img_feature_dim=2054, num_labels=4)


def _same(a, b) -> bool:
    fa, ea = a
    fb, eb = b
    return ea == eb and fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_one_seed_repeats():
    big = 2**31 + 12345
    assert _same(synthetic.make_pool(big, 16, GEO, labels=True),
                 synthetic.make_pool(big, 16, GEO, labels=True))


def test_two_seeds_differ():
    a = synthetic.make_pool(2**31 + 1, 16, GEO, labels=True)
    b = synthetic.make_pool(2**31 + 2, 16, GEO, labels=True)
    assert a[1] != b[1]


def test_the_copy_draws_what_the_program_draws():
    cfg = ModCRConfig()
    for labelled in (False, True):
        fn = program_synthetic.synthetic_examples if labelled else program_synthetic.synthetic_requests
        pf, pe = fn(np.random.default_rng(7), 12, cfg)
        bf, be = synthetic.make_pool(7, 12, GEO, labels=labelled)
        assert [dataclasses.astuple(e)[:5] for e in pe] == [tuple(e) for e in be]
        assert all(np.array_equal(pf[k].features, bf[k]) for k in bf)


def test_every_seed_gives_the_same_batch_shapes():
    conf = tiny.configs()["modcr_pmr"]
    geo = reference.geometry("modcr", conf["model"])
    shapes = set()
    for seed in (1, 2**31 + 5, 2**32 + 9):
        feats, exs = synthetic.make_pool(seed, 8, geo, labels=True)
        batch = port.Dataset(exs, feats, geo, memo=False).batch(list(range(8)))
        shapes.add(tuple(sorted((k, v.shape) for k, v in batch.items())))
    assert len(shapes) == 1
