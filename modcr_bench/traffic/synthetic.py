"""Seeded PMR traffic: a frozen copy of the generators of the port's
``serving/synthetic.py`` (``synthetic_requests`` and ``synthetic_examples``),
kept here so that a change to the program cannot change what the benchmark
sends.  The draws are the same, in the same order, as the original's.

An example is a plain :class:`Example`; its image is a float32 array
[regions, feature dim].  Both the program (through its own dataset) and
the plain reference featurize these raw examples themselves.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

WORDS = ("man woman dog cup table street car child holds looks walks near "
         "angry happy talking running sitting bag phone window").split()


class Example(NamedTuple):
    example_id: str
    img_id: str
    premise: str                     # <|det#|> region tokens inline
    answer_choices: List[str]
    answer_label: Optional[Union[int, List[int]]]


def requests(rng: np.random.Generator, n: int, *, img_len: int, img_feature_dim: int,
             num_labels: int, first: int = 0
             ) -> Tuple[Dict[str, np.ndarray], List[Example]]:
    """``n`` requests ``req-{first}..``, each with its own image of 10 to
    ``img_len`` regions; returns ``(features by image id, examples)``."""
    feats, examples = {}, []
    for i in range(first, first + n):
        n_reg = int(rng.integers(min(10, img_len), img_len + 1))
        feats[f"img-{i}"] = rng.standard_normal((n_reg, img_feature_dim), dtype=np.float32)

        def sentence(lo, hi):
            toks = [str(rng.choice(WORDS)) for _ in range(int(rng.integers(lo, hi)))]
            for _ in range(int(rng.integers(1, 3))):
                toks.insert(int(rng.integers(0, len(toks) + 1)),
                            f"<|det{int(rng.integers(0, min(n_reg, 45)))}|>")
            return " ".join(toks) + " ."

        examples.append(Example(
            example_id=f"req-{i}", img_id=f"img-{i}", premise=sentence(12, 30),
            answer_choices=[sentence(4, 12) for _ in range(num_labels)],
            answer_label=None,
        ))
    return feats, examples


def labelled(rng: np.random.Generator, n: int, *, img_len: int, img_feature_dim: int,
             num_labels: int, first: int = 0, multi_label_share: float = 0.2
             ) -> Tuple[Dict[str, np.ndarray], List[Example]]:
    """:func:`requests` with labels: one gold candidate drawn uniformly, or,
    for about ``multi_label_share`` of the examples, a sorted list of two
    (PMR's multi-label rows)."""
    feats, examples = requests(rng, n, img_len=img_len, img_feature_dim=img_feature_dim,
                               num_labels=num_labels, first=first)
    out = []
    for ex in examples:
        if rng.random() < multi_label_share:
            label = sorted(int(x) for x in rng.choice(num_labels, size=2, replace=False))
        else:
            label = int(rng.integers(num_labels))
        out.append(ex._replace(answer_label=label))
    return feats, out


def make_pool(seed: int, n: int, geometry: Dict, *, labels: bool,
              multi_label_share: float = 0.2) -> Tuple[Dict[str, np.ndarray], List[Example]]:
    """The pool of a run: ``n`` examples drawn from ``seed`` at the
    configuration's ``geometry`` (``img_len``, ``img_feature_dim``,
    ``num_labels``), labelled or not."""
    rng = np.random.default_rng(seed)
    kw = dict(img_len=geometry["img_len"], img_feature_dim=geometry["img_feature_dim"],
              num_labels=geometry["num_labels"])
    if labels:
        return labelled(rng, n, multi_label_share=multi_label_share, **kw)
    return requests(rng, n, **kw)
