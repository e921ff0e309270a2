"""PMR dataset pipeline (a copy of the JAX package's ``data/pmr.py``
without its device-table mode).

Rebuilds ``PMR_ChunkAlign_Dataset_align_ensemble_T``
(Data/VCRChunkAlign.py:529-688) as a host-side numpy featurizer:
:func:`load_pmr_jsonl` reads the raw ``pmr_data/*.jsonl`` schema,
:class:`PMRDataset` featurizes an example into its candidate rows (cached
per index, LRU-bounded) and collates index lists into fixed-shape batches.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_context_reasoning_torch.data.chunker import HeuristicChunker
from multimodal_context_reasoning_torch.data.collate import BatchSpec, collate_candidates, table_rows
from multimodal_context_reasoning_torch.data.schemas import (
    CandidateFeatures,
    ImageFeatures,
    RawExample,
)
from multimodal_context_reasoning_torch.data.tokenization import Tokenizer, det_index
from multimodal_context_reasoning_torch.utils.profiling import count, span

# Prompt template, verbatim from Data/VCRChunkAlign.py:607-608 / 628.
PROMPT_TEXT = (
    "Is Answer correct or wrong based on the Conditions? Conditions: "
    "Image Description is <mask>, Bridge between Image and the following "
    "texts is <mask>, Premise Text is "
)
ANSWER_PREFIX = "Answer is "


def detokenize_with_dets(tokens: Sequence, objects: Sequence[str]) -> str:
    """Raw PMR token list (strings + [obj_idx] lists) → flat string with
    inline ``<|det#|>`` region tokens."""
    parts: List[str] = []
    for tok in tokens:
        if isinstance(tok, list):
            refs = [f"{objects[i] if i < len(objects) else 'object'} <|det{i}|>"
                    for i in tok]
            parts.append(" and ".join(refs))
        else:
            parts.append(str(tok))
    return " ".join(parts)


def load_pmr_jsonl(path: str, limit: Optional[int] = None) -> List[RawExample]:
    """Parse pmr_data/{train,val,test}-ori.jsonl into RawExamples."""
    out: List[RawExample] = []
    with open(path) as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            d = json.loads(line)
            objects = d.get("objects", [])
            out.append(RawExample(
                example_id=str(d.get("total_id", d.get("annot_id", i))),
                img_id=str(d.get("img_id", d.get("img_fn", i))),
                premise=detokenize_with_dets(d["premise"], objects),
                answer_choices=[
                    detokenize_with_dets(a, objects) for a in d["answer_choices"]
                ],
                answer_label=d.get("answer_label"),
                answer_types=d.get("answer_types"),
                objects=list(objects),
            ))
    return out


class PMRDataset:
    """Featurizes RawExamples into fixed-shape candidate batches."""

    def __init__(
        self,
        examples: Sequence[RawExample],
        image_features: Dict[str, ImageFeatures],
        bert_tokenizer: Tokenizer,
        roberta_tokenizer: Tokenizer,
        spec: Optional[BatchSpec] = None,
        chunker: Optional[HeuristicChunker] = None,
        max_chunks: int = 40,
        feat_cache_size: Optional[int] = 65536,
    ):
        self.examples = list(examples)
        self.image_features = image_features
        self.bert = bert_tokenizer
        self.roberta = roberta_tokenizer
        self.spec = spec or BatchSpec()
        self.chunker = chunker or HeuristicChunker()
        self.max_chunks = max_chunks
        # LRU-bounded featurization cache: None = unbounded, 0 = disabled.
        # The lock makes hit/evict safe under the loader's producer thread.
        self.feat_cache_size = feat_cache_size
        self._feat_cache: "OrderedDict[int, List[CandidateFeatures]]" = OrderedDict()
        self._feat_cache_lock = threading.Lock()
        self.device_table = None   # use_device_table

    def __len__(self) -> int:
        return len(self.examples)

    def _target(self, answer_label, ans_idx: int) -> float:
        # Data/VCRChunkAlign.py:672-681: list labels → multi-hot.
        if answer_label is None:
            return 0.0
        if isinstance(answer_label, list):
            return 1.0 if ans_idx in answer_label else 0.0
        return 1.0 if ans_idx == answer_label else 0.0

    def bert_answer(self, ans: str) -> str:
        """The answer text of the BERT stream."""
        return ans

    def roberta_question(self, premise: str) -> str:
        """The question text of the RoBERTa stream, after the prompt."""
        return PROMPT_TEXT + premise.lower()

    def roberta_answer(self, ans: str) -> str:
        """The answer text of the RoBERTa stream, after its prefix."""
        return ANSWER_PREFIX + " ".join(ans.split(" , "))

    def featurize(self, ex: RawExample) -> List[CandidateFeatures]:
        """One example → num_labels candidate feature rows."""
        spec = self.spec
        premise_tokens = self.bert.tokenize(ex.premise.lower())
        r_que = self.roberta.tokenize(self.roberta_question(ex.premise))

        out: List[CandidateFeatures] = []
        for ans_idx, ans in enumerate(ex.answer_choices):
            ans_tokens = self.bert.tokenize(self.bert_answer(ans))
            toks = (
                [self.bert.cls_token] + premise_tokens + [self.bert.sep_token]
                + ans_tokens + [self.bert.sep_token]
            )
            toks = toks[: spec.text_len]
            input_ids = np.asarray(self.bert.convert_tokens_to_ids(toks), np.int32)
            t = len(toks)
            token_type_ids = np.zeros((t,), np.int32)
            ans_start = min(len(premise_tokens) + 2, t)
            token_type_ids[ans_start:] = 1

            # <|det#|> region labels
            total_label = np.zeros((t,), np.int32)
            for pos, tok in enumerate(toks):
                di = det_index(tok)
                if di is not None:
                    total_label[pos] = di
            align_pos = (total_label != 0).astype(np.int32)

            # chunk ids over the full [CLS]..[SEP] sequence
            gather_index = self.chunker.gather_index(
                toks[1:t - 1] if t >= 2 else [],
                offset=1, total_len=t, max_chunks=self.max_chunks,
            )

            # RoBERTa stream
            r_ans = self.roberta.tokenize(self.roberta_answer(ans))
            r_toks = (
                [self.roberta.cls_token] + r_que + [self.roberta.sep_token]
                + r_ans + [self.roberta.sep_token]
            )
            r_toks = r_toks[: spec.roberta_len]
            r_input_ids = np.asarray(
                self.roberta.convert_tokens_to_ids(r_toks), np.int32
            )

            out.append(CandidateFeatures(
                input_ids=input_ids,
                token_type_ids=token_type_ids,
                gather_index=gather_index,
                total_label=total_label,
                align_pos=align_pos,
                r_input_ids=r_input_ids,
                r_token_type_ids=np.zeros((len(r_toks),), np.int32),
                target=self._target(ex.answer_label, ans_idx),
            ))
        return out

    def get_image(self, ex: RawExample) -> ImageFeatures:
        key = ex.img_id
        if key in self.image_features:
            return self.image_features[key]
        # the reference keys features as "img-<num>" (Data/VCRChunkAlign.py:586-588)
        num = key.split("-")[-1]
        return self.image_features[f"img-{num}"]

    def _featurize_cached(self, i: int) -> List[CandidateFeatures]:
        """Featurization is deterministic, so per-index results are memoized
        (LRU-bounded by ``feat_cache_size``): multi-epoch training
        re-tokenizes nothing."""
        if self.feat_cache_size == 0:
            with span("data.featurize"):
                return self.featurize(self.examples[i])
        with self._feat_cache_lock:
            cached = self._feat_cache.get(i)
            if cached is not None:
                self._feat_cache.move_to_end(i)
                count("data.memo_hit")
                return cached
        count("data.memo_miss")
        with span("data.featurize"):
            cached = self.featurize(self.examples[i])  # slow path: outside lock
        with self._feat_cache_lock:
            self._feat_cache[i] = cached
            if (self.feat_cache_size is not None
                    and len(self._feat_cache) > self.feat_cache_size):
                self._feat_cache.popitem(last=False)
        return cached

    def use_device_table(self, table) -> None:
        """Switch batches to device-table mode (data/device_table.py): the
        features are gathered on the device from the resident table, and
        each batch ships only per-row int32 ids."""
        self.device_table = table

    def batch(self, indices: Sequence[int]) -> Dict:
        """Collate the examples at ``indices`` into one candidate batch; in
        device-table mode ``img_row`` and the table's resident tensors take
        the place of ``img_feat`` / ``img_mask``."""
        cands = [self._featurize_cached(int(i)) for i in indices]
        exs = [self.examples[int(i)] for i in indices]
        table = self.device_table
        with span("data.collate"):
            if table is None:
                return collate_candidates(cands, [self.get_image(ex) for ex in exs], self.spec)
            out = collate_candidates(cands, None, self.spec)
        out["img_row"] = table_rows(table, [ex.img_id for ex in exs], self.spec.num_labels)
        # the same device tensors every batch: nothing is copied again
        out["feat_table"] = table.table
        out["feat_mask_table"] = table.mask
        return out
