"""PMR request featurization (the featurizer of the JAX package's
``data/pmr.py``; its JSONL loader, training cache and batching are left
out).

Rebuilds the per-candidate featurization of
``PMR_ChunkAlign_Dataset_align_ensemble_T`` (Data/VCRChunkAlign.py:615-687)
as host-side numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_context_reasoning_torch.data.chunker import HeuristicChunker
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.schemas import (
    CandidateFeatures,
    ImageFeatures,
    RawExample,
)
from multimodal_context_reasoning_torch.data.tokenization import Tokenizer, det_index

# Prompt template, verbatim from Data/VCRChunkAlign.py:607-608 / 628.
PROMPT_TEXT = (
    "Is Answer correct or wrong based on the Conditions? Conditions: "
    "Image Description is <mask>, Bridge between Image and the following "
    "texts is <mask>, Premise Text is "
)
ANSWER_PREFIX = "Answer is "


class PMRDataset:
    """Featurizes RawExamples into candidate feature rows."""

    def __init__(
        self,
        examples: Sequence[RawExample],
        image_features: Dict[str, ImageFeatures],
        bert_tokenizer: Tokenizer,
        roberta_tokenizer: Tokenizer,
        spec: Optional[BatchSpec] = None,
        chunker: Optional[HeuristicChunker] = None,
        max_chunks: int = 40,
    ):
        self.examples = list(examples)
        self.image_features = image_features
        self.bert = bert_tokenizer
        self.roberta = roberta_tokenizer
        self.spec = spec or BatchSpec()
        self.chunker = chunker or HeuristicChunker()
        self.max_chunks = max_chunks

    def __len__(self) -> int:
        return len(self.examples)

    def _target(self, answer_label, ans_idx: int) -> float:
        # Data/VCRChunkAlign.py:672-681: list labels → multi-hot.
        if answer_label is None:
            return 0.0
        if isinstance(answer_label, list):
            return 1.0 if ans_idx in answer_label else 0.0
        return 1.0 if ans_idx == answer_label else 0.0

    def featurize(self, ex: RawExample) -> List[CandidateFeatures]:
        """One example → num_labels candidate feature rows."""
        spec = self.spec
        premise_tokens = self.bert.tokenize(ex.premise.lower())
        r_que = self.roberta.tokenize(PROMPT_TEXT + ex.premise.lower())

        out: List[CandidateFeatures] = []
        for ans_idx, ans in enumerate(ex.answer_choices):
            ans_tokens = self.bert.tokenize(ans)
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
            r_ans = self.roberta.tokenize(ANSWER_PREFIX + " ".join(ans.split(" , ")))
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
