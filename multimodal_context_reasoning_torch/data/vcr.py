"""VCR (Visual Commonsense Reasoning) dataset pipeline (port of the JAX
package's ``data/vcr.py``).

Rebuilds ``VCR_only_ChunkAlign_Dataset_align_ensemble_T``
(Data/VCRChunkAlign.py:744-952) over the raw ``vcr_data/vcr_val.json``
line-delimited schema (same token-list shape as PMR: premise / 4
answer_choices as lists of strings and ``[obj_idx, ...]`` reference lists,
plus ``objects`` names — vcr_data/vcr_val.json:1).

VCR-specific behaviors preserved:

- the answer-truncation heuristic against the roberta-side answer string
  (Data/VCRChunkAlign.py:851-854): if the roberta answer is a prefix of the
  BERT answer, the BERT answer keeps only 10 extra whitespace tokens;
- integer ``answer_label`` defaulting to 0 when missing (:806-809);
- the same prompt template and ``Answer is`` prefix as PMR (:821-823, 836),
  with the answer text taken as it is (PMR rejoins " , ").

The JAX ``VCRDataset``'s ``lm_style="gpt"`` framing serves the GPT-2
ensemble, which the port does not have yet.
"""

from __future__ import annotations

import json
from typing import List, Optional

from multimodal_context_reasoning_torch.data.pmr import (
    ANSWER_PREFIX,
    PMRDataset,
    detokenize_with_dets,
)
from multimodal_context_reasoning_torch.data.schemas import RawExample


def load_vcr_json(path: str, limit: Optional[int] = None) -> List[RawExample]:
    """Parse vcr_data/vcr_val.json (line-delimited) into RawExamples."""
    out: List[RawExample] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            if limit is not None and len(out) >= limit:
                break
            d = json.loads(line)
            objects = d.get("objects", [])
            out.append(RawExample(
                example_id=str(d.get("annot_id", d.get("total_id", i))),
                img_id=str(d.get("img_id", d.get("img_fn", i))),
                premise=detokenize_with_dets(d["premise"], objects),
                answer_choices=[
                    detokenize_with_dets(a, objects) for a in d["answer_choices"]
                ],
                answer_label=d.get("answer_label", 0),
                answer_types=d.get("answer_types"),
                objects=list(objects),
            ))
    return out


def truncate_answer(ans: str, r_ans: str, extra_tokens: int = 10) -> str:
    """VCR answer-truncation heuristic (Data/VCRChunkAlign.py:851-854).

    If the roberta answer string occurs inside the BERT-side answer, keep the
    roberta answer plus at most ``extra_tokens`` following whitespace tokens.
    """
    if r_ans and r_ans in ans:
        tail = ans.split(r_ans, 1)[1]
        return r_ans + " ".join(tail.split()[:extra_tokens])
    return ans


class VCRDataset(PMRDataset):
    """VCR featurizer — the PMR pipeline with VCR's answer texts.

    The reference keeps separate BERT-side and RoBERTa-side example pickles
    (`VCR_example_file` vs `roberta_example_file`, Data/VCRChunkAlign.py:746-749)
    whose answer strings may differ; here both sides derive from the same raw
    example, so the truncation reduces to capping the BERT answer at
    len(answer)+10 tokens — the heuristic is applied verbatim for parity.
    """

    def bert_answer(self, ans: str) -> str:
        return truncate_answer(ans, ans)   # the roberta-side answer is the same text

    def roberta_answer(self, ans: str) -> str:
        return ANSWER_PREFIX + ans
