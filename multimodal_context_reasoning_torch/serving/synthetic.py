"""Synthetic PMR requests and hash tokenizers for driving the scorer without
a dataset or checkpoint: random region features and short premises and
answers with ``<|det#|>`` tokens, all drawn from a numpy generator."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures, RawExample
from multimodal_context_reasoning_torch.data.tokenization import (
    HashTokenizer,
    RobertaHashTokenizer,
)

WORDS = ("man woman dog cup table street car child holds looks walks near "
         "angry happy talking running sitting bag phone window").split()


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


def hash_tokenizers(cfg: ModCRConfig) -> Tuple[HashTokenizer, RobertaHashTokenizer]:
    """The BERT and RoBERTa hash tokenizers, ids kept below each tower's vocab."""
    return (HashTokenizer(vocab_size=cfg.global_encoder.vocab_size),
            RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size))
