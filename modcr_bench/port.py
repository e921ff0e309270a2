"""What the benchmark takes from the program under test,
``multimodal_context_reasoning_torch``: its configuration class, its
model, its dataset and loader, and its eval step.  The weights are the benchmark's own (``weights.py``), loaded
into the program's model by name."""

from __future__ import annotations

import copy
import json
import threading
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.pmr import PMRDataset
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures, RawExample
from multimodal_context_reasoning_torch.data.tokenization import (
    HashTokenizer,
    RobertaHashTokenizer,
)
from multimodal_context_reasoning_torch.models.modcr import ModCRModel

from . import weights


def merged(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over`` merged in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def model_dict(conf: Dict, cell: Dict) -> Dict:
    """The configuration's model dict as this cell runs it."""
    return merged(conf["model"], cell.get("model", {}))


def build_model(conf: Dict, m: Dict, seed: int, device) -> torch.nn.Module:
    """The program's model of configuration ``conf`` at ``m`` with the
    seed's weights."""
    net = ModCRModel(ModCRConfig.from_json(json.dumps(m)), device=device)
    sd = weights.for_model(conf, m, seed, device)
    net.load_state_dict(sd, strict=True)
    del sd
    return net


class Dataset(PMRDataset):
    """The program's PMR dataset over the benchmark's raw examples, with
    the hash tokenizers at the towers' vocabularies.  It records the
    example indices of every batch it collates, in order, so that the
    check knows which examples each timed step took."""

    def __init__(self, examples: Sequence, feats: Dict[str, np.ndarray], geo: Dict, *,
                 memo: bool):
        raw = [RawExample(example_id=e.example_id, img_id=e.img_id, premise=e.premise,
                          answer_choices=list(e.answer_choices), answer_label=e.answer_label)
               for e in examples]
        images = {k: ImageFeatures(features=v, num_regions=v.shape[0]) for k, v in feats.items()}
        spec = BatchSpec(text_len=geo["text_len"], img_len=geo["img_len"],
                         roberta_len=geo["roberta_len"], num_labels=geo["num_labels"],
                         img_feature_dim=geo["img_feature_dim"])
        super().__init__(raw, images, HashTokenizer(vocab_size=geo["bert_vocab"]),
                         RobertaHashTokenizer(vocab_size=geo["roberta_vocab"]), spec=spec,
                         max_chunks=geo["max_chunks"], feat_cache_size=None if memo else 0)
        self.taken: List[np.ndarray] = []
        self._taken_lock = threading.Lock()

    def batch(self, indices):
        with self._taken_lock:
            self.taken.append(np.asarray(indices).copy())
        return super().batch(indices)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """As the program's ``Trainer.to_device``: every host array copied."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}


def quantized(m: Dict) -> Dict:
    """``m`` with every ModCR tower's products on the program's W8A8 int8
    route (``ModCRConfig.with_quantize``)."""
    return merged(m, {t: {"quantize": "int8"} for t in ("global_encoder", "seq_encoder", "roberta")})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def epochs(loader):
    """The loader's batches, epoch after epoch (reshuffled each)."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


class Phases:
    """Seconds of each part of a set-up, for the run's standard error."""

    def __init__(self):
        self.last = time.perf_counter()
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 3)
        self.last = now
