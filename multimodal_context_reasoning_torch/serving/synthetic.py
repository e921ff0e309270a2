"""Synthetic PMR requests and hash tokenizers for driving the scorer and
the trainer without a dataset or checkpoint: random region features and
short premises and answers with ``<|det#|>`` tokens, all drawn from a numpy
generator, labelled datasets for training, and raw PMR / VCR rows and
region features in the files the CLIs read; per-image features seeded from
the image id (:func:`synthetic_features`)."""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Dict, Iterable, List, Tuple

import numpy as np

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.pmr import PMRDataset
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures, RawExample
from multimodal_context_reasoning_torch.data.tokenization import (
    HashTokenizer,
    RobertaHashTokenizer,
)

WORDS = ("man woman dog cup table street car child holds looks walks near "
         "angry happy talking running sitting bag phone window").split()
OBJECTS = ("person", "dog", "car", "cup", "bag", "table", "chair", "phone")


def synthetic_requests(rng: np.random.Generator, n: int, cfg: ModCRConfig,
                       first: int = 0) -> Tuple[Dict[str, ImageFeatures], List[RawExample]]:
    """``n`` requests ``req-{first}..``, each with its own image of 10 to
    ``img_len`` regions; returns ``(image features by id, examples)``."""
    feats, examples = {}, []
    for i in range(first, first + n):
        n_reg = int(rng.integers(min(10, cfg.img_len), cfg.img_len + 1))
        feats[f"img-{i}"] = ImageFeatures(
            features=rng.standard_normal((n_reg, cfg.global_encoder.img_feature_dim),
                                         dtype=np.float32),
            num_regions=n_reg,
        )

        def sentence(lo, hi):
            toks = [str(rng.choice(WORDS)) for _ in range(int(rng.integers(lo, hi)))]
            for _ in range(int(rng.integers(1, 3))):
                toks.insert(int(rng.integers(0, len(toks) + 1)),
                            f"<|det{int(rng.integers(0, min(n_reg, 45)))}|>")
            return " ".join(toks) + " ."

        examples.append(RawExample(
            example_id=f"req-{i}", img_id=f"img-{i}", premise=sentence(12, 30),
            answer_choices=[sentence(4, 12) for _ in range(cfg.num_labels)],
            answer_label=None,
        ))
    return feats, examples


def synthetic_examples(rng: np.random.Generator, n: int, cfg: ModCRConfig,
                       first: int = 0, multi_label_share: float = 0.2,
                       ) -> Tuple[Dict[str, ImageFeatures], List[RawExample]]:
    """:func:`synthetic_requests` with labels: one gold candidate drawn
    uniformly, or, for about ``multi_label_share`` of the examples, a list
    of two (PMR's multi-label rows, multi-hot targets)."""
    feats, examples = synthetic_requests(rng, n, cfg, first)
    K = cfg.num_labels
    labelled = []
    for ex in examples:
        if rng.random() < multi_label_share:
            label = sorted(int(x) for x in rng.choice(K, size=2, replace=False))
        else:
            label = int(rng.integers(K))
        labelled.append(dataclasses.replace(ex, answer_label=label))
    return feats, labelled


def hash_tokenizers(cfg: ModCRConfig) -> Tuple[HashTokenizer, RobertaHashTokenizer]:
    """The BERT and RoBERTa hash tokenizers, ids kept below each tower's vocab."""
    return (HashTokenizer(vocab_size=cfg.global_encoder.vocab_size),
            RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size))


def synthetic_dataset(rng: np.random.Generator, n: int, cfg: ModCRConfig,
                      first: int = 0) -> PMRDataset:
    """A :class:`PMRDataset` of ``n`` :func:`synthetic_examples` in ``cfg``'s
    batch geometry, tokenized by :func:`hash_tokenizers`."""
    feats, examples = synthetic_examples(rng, n, cfg, first)
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len,
                     roberta_len=cfg.roberta_len, num_labels=cfg.num_labels,
                     img_feature_dim=cfg.global_encoder.img_feature_dim)
    return PMRDataset(examples, feats, *hash_tokenizers(cfg), spec=spec,
                      max_chunks=cfg.max_chunks)


def task_rows(rng: np.random.Generator, n: int, n_regions: int, *, vcr: bool = False,
              first: int = 0, num_labels: int = 4, words: Tuple[int, int] = (12, 30)
              ) -> List[dict]:
    """``n`` raw rows in the schema of ``load_pmr_jsonl`` (or, with ``vcr``,
    of ``load_vcr_json``): premise and answers as token lists in which
    ``[i, ...]`` lists refer to the row's objects, one image ``img-<i>``
    per row with at most ``n_regions`` objects, an integer label.  A
    premise has ``words`` words (the range), an answer a third of that."""
    rows = []
    for i in range(first, first + n):
        n_objects = int(rng.integers(2, min(8, n_regions) + 1))
        objects = [str(rng.choice(OBJECTS)) for _ in range(n_objects)]

        def tokens(lo, hi):
            toks: list = [str(rng.choice(WORDS)) for _ in range(int(rng.integers(lo, hi)))]
            for _ in range(int(rng.integers(1, 3))):
                ref = sorted(set(int(x) for x in rng.integers(0, len(objects), 2)))
                toks.insert(int(rng.integers(0, len(toks) + 1)), ref)
            return toks + ["."]

        row = {"img_id": f"img-{i}", "premise": tokens(*words),
               "answer_choices": [tokens(max(words[0] // 3, 1), max(words[1] // 3, 2))
                                  for _ in range(num_labels)],
               "answer_label": int(rng.integers(num_labels)), "objects": objects}
        if vcr:
            row["annot_id"] = f"val-{i}"
        else:
            row["total_id"] = i
            row["answer_types"] = [int(t) for t in rng.integers(0, 3, num_labels)]
        rows.append(row)
    return rows


def write_rows(path: str, rows: List[dict]) -> None:
    """One JSON object per line, as pmr_data/*.jsonl and vcr_data/*.json."""
    with open(path, "w") as f:
        f.writelines(json.dumps(row) + "\n" for row in rows)


def region_features(rng: np.random.Generator, rows: List[dict], n_regions: int,
                    dim: int) -> Dict[str, np.ndarray]:
    """[n_regions, dim] float32 features for each row's image."""
    return {row["img_id"]: rng.standard_normal((n_regions, dim), dtype=np.float32)
            for row in rows}


def synthetic_features(img_ids: Iterable[str], dim: int,
                       max_regions: int = 20) -> Dict[str, ImageFeatures]:
    """Per-image region features seeded from the image id, 5 to
    ``max_regions`` regions each: the same arrays as the JAX package's
    ``scripts/train_real_pmr.py::synthetic_features`` (``zlib.crc32`` is
    stable across processes, ``hash`` of a str is not)."""
    out = {}
    for img_id in img_ids:
        seed = zlib.crc32(f"pmr-feat:{img_id}".encode()) % (2**31)
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, max_regions + 1))
        out[str(img_id)] = ImageFeatures(
            features=rng.standard_normal((n, dim)).astype(np.float32), num_regions=n)
    return out
