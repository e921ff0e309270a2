"""Vision-language task processors (VQA / GQA / NLVR2 / VCR Q-A/QA-R/Q-AR);
a copy of the JAX package's ``data/task_processors.py`` (stdlib only).

Capability parity with the Oscar task registry (utils/task_utils.py:81-594):
each processor reads a split file into :class:`VLExample` records carrying
(text_a, text_b, image key, label) and exposes its label set; a shared
featurizer turns them into padded id arrays.  The original supports json
(VQA-style) and jsonl corpora; score-weighted multi-answer VQA labels are
preserved.

Registries at the bottom mirror ``processors`` / ``output_modes`` /
``GLUE_TASKS_NUM_LABELS`` (utils/task_utils.py:567-594).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Type


@dataclasses.dataclass
class VLExample:
    guid: str
    text_a: str
    text_b: Optional[str] = None
    img_key: Optional[str] = None
    label: Optional[object] = None     # str, int, or list (VQA multi-answer)
    score: Optional[object] = None     # VQA answer confidences


def _read_json(path: str) -> List[dict]:
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


class VLProcessor:
    """Base: split-file discovery + example construction."""

    train_file = "train.json"
    dev_file = "val.json"
    test_file = "test.json"

    def get_train_examples(self, data_dir: str, file_name: Optional[str] = None):
        return self._create(_read_json(
            os.path.join(data_dir, file_name or self.train_file)), "train")

    def get_dev_examples(self, data_dir: str, file_name: Optional[str] = None):
        return self._create(_read_json(
            os.path.join(data_dir, file_name or self.dev_file)), "dev")

    def get_test_examples(self, data_dir: str, file_name: Optional[str] = None):
        return self._create(_read_json(
            os.path.join(data_dir, file_name or self.test_file)), "test")

    def get_labels(self, label_file: Optional[str] = None) -> List:
        raise NotImplementedError

    def _create(self, rows: Sequence[dict], split: str) -> List[VLExample]:
        raise NotImplementedError


def load_ans2label(path: str) -> dict:
    """Load a VQA answer→label-id vocabulary (utils/ans2label.json, 3,129
    entries; the dict `cPickle.load`ed at utils/task_utils.py:109/158/206).

    Accepts the reference's JSON rendering or a pickle (the reference ships
    both spellings); returns the answer-string → int-label mapping.
    """
    if path.endswith((".pkl", ".pickle")):
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f)
    with open(path) as f:
        return json.load(f)


class VQAProcessor(VLProcessor):
    """VQA v2 (utils/task_utils.py:81-177): question + image, multi-answer
    labels with confidence scores from ans2label."""

    def get_labels(self, label_file: Optional[str] = None):
        """Label ids, as the reference returns them
        (`list(ans2label.values())`, utils/task_utils.py:110)."""
        if label_file:
            return list(load_ans2label(label_file).values())
        return None  # open vocabulary until ans2label is supplied

    def _create(self, rows, split):
        out = []
        for i, d in enumerate(rows):
            out.append(VLExample(
                guid=f"{split}-{d.get('q_id', i)}",
                text_a=d.get("q") or d.get("question", ""),
                img_key=str(d.get("img_id", d.get("image_id", ""))),
                label=d.get("label"),
                score=d.get("score"),
            ))
        return out


class GQAProcessor(VLProcessor):
    """GQA (utils/task_utils.py:178-225): single-answer classification."""

    def get_labels(self, label_file: Optional[str] = None):
        """Label ids (`list(ans2label.values())`, utils/task_utils.py:159)."""
        if label_file:
            return list(load_ans2label(label_file).values())
        return None

    def _create(self, rows, split):
        return [VLExample(
            guid=f"{split}-{d.get('q_id', i)}",
            text_a=d.get("q") or d.get("question", ""),
            img_key=str(d.get("img_id", d.get("image_id", ""))),
            label=d.get("label"),
        ) for i, d in enumerate(rows)]


class NLVRProcessor(VLProcessor):
    """NLVR2 (utils/task_utils.py:226-272): statement over an image pair,
    binary true/false."""

    def get_labels(self, label_file: Optional[str] = None):
        return [0, 1]

    def _create(self, rows, split):
        return [VLExample(
            guid=f"{split}-{d.get('identifier', i)}",
            text_a=d.get("sent") or d.get("sentence", ""),
            img_key=str(d.get("img_id", d.get("identifier", ""))),
            label={"False": 0, "True": 1}.get(str(d.get("label")), d.get("label")),
        ) for i, d in enumerate(rows)]


class VCRProcessor(VLProcessor):
    """VCR Q→A / QA→R / Q→AR (utils/task_utils.py:273-417): question +
    4 candidates, answer_label / rationale_label indices."""

    mode = "qa"  # qa | qar | q_ar

    def get_labels(self, label_file: Optional[str] = None):
        return [0, 1, 2, 3]

    def _create(self, rows, split):
        out = []
        for i, d in enumerate(rows):
            q = d.get("question", d.get("premise", ""))
            if isinstance(q, list):
                q = " ".join(str(t) for t in q)
            if self.mode == "qar":
                gold_ans = d.get("answer_choices", [""])[d.get("answer_label", 0)]
                if isinstance(gold_ans, list):
                    gold_ans = " ".join(str(t) for t in gold_ans)
                q = f"{q} {gold_ans}"
                choices = d.get("rationale_choices", [])
                label = d.get("rationale_label")
            else:
                choices = d.get("answer_choices", [])
                label = d.get("answer_label")
            for k, choice in enumerate(choices):
                if isinstance(choice, list):
                    choice = " ".join(str(t) for t in choice)
                out.append(VLExample(
                    guid=f"{split}-{d.get('annot_id', i)}-{k}",
                    text_a=q,
                    text_b=choice,
                    img_key=str(d.get("img_id", "")),
                    label=1 if label == k else 0,
                ))
        return out


class VCRQAToRProcessor(VCRProcessor):
    mode = "qar"


# Registries (utils/task_utils.py:567-594)
PROCESSORS: Dict[str, Type[VLProcessor]] = {
    "vqa_text": VQAProcessor,
    "gqa": GQAProcessor,
    "nlvr": NLVRProcessor,
    "vcr_q_a": VCRProcessor,
    "vcr_qa_r": VCRQAToRProcessor,
}

OUTPUT_MODES: Dict[str, str] = {
    "vqa_text": "classification",
    "gqa": "classification",
    "nlvr": "classification",
    "vcr_q_a": "classification",
    "vcr_qa_r": "classification",
}

TASK_NUM_LABELS: Dict[str, int] = {
    "vqa_text": 3129,
    "gqa": 1853,
    "nlvr": 2,
    "vcr_q_a": 2,
    "vcr_qa_r": 2,
}
