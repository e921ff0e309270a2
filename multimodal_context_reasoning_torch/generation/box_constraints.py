"""Box-driven constraint selection for FSM-constrained beam search (a copy
of the JAX package's ``generation/box_constraints.py``: host-side numpy,
the same outputs).

Rebuilds the front-end of the reference's FSM-CBS pipeline
(utils/cbs.py:435-630) that turns Open-Images object detections into the
lexical constraints consumed by
:class:`generation.fsm.FiniteStateMachineBuilder`:

- :func:`load_wordforms` — the two-column TSV reader mapping a word to its
  comma-separated interchangeable forms (utils/cbs.py:435-441); also used
  for the ``constraint2tokens`` file that maps a class word to its
  tokenizer words.
- :class:`ConstraintBoxesReader` — detection-TSV reader keyed by image
  (utils/cbs.py:444-468).
- :class:`ClassHierarchy` — anytree-free Open-Images class hierarchy: the
  JSON tree (``LabelName``/``Subcategory`` nodes) is flattened to a
  pre-order list with per-node heights, reproducing
  ``anytree.search.findall(root, lambda n: n.LabelName.lower() in c)[0]``
  — the FIRST pre-order node whose label is a SUBSTRING of the class name
  (utils/cbs.py:585-590, including the substring-match semantics).
- :class:`ConstraintFilter` — blacklist + hierarchy-NMS + top-k + name
  replacements (utils/cbs.py:477-630).  The NMS keep-condition is
  transcribed exactly (``heights[others] >= heights[current]`` OR low IoU,
  :616-619); because ``score_order`` is sorted by height ascending, the
  current box always has the minimal remaining height, so the condition
  never suppresses anything — the reference's hierarchy NMS is a
  de-facto identity reordering, and this port deliberately preserves
  that observable behavior rather than "fixing" it.  One deviation: the
  reference's final ``list(set(names))`` (:553) has hash-randomized
  order across processes; we dedup preserving first-occurrence order
  (same set, deterministic order).
- :func:`tokenize_constraints` — class names → the nested
  [constraint][word][wordform-token-id] lists the FSM builder consumes,
  replicating ``_add_nth_constraint``'s word expansion
  (split → constraint2tokens → cap at max_words) and ``_connect``'s
  wordform lookup (utils/cbs.py:774-780,845-847).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Open-Images classes never used as constraints: too rare, not commonly
# uttered, or covered by COCO (utils/cbs.py:503-513).
BLACKLIST: Tuple[str, ...] = (
    "auto part", "bathroom accessory", "bicycle wheel", "boy", "building",
    "clothing", "door handle", "fashion accessory", "footwear", "girl",
    "hiking equipment", "human arm", "human beard", "human body",
    "human ear", "human eye", "human face", "human foot", "human hair",
    "human hand", "human head", "human leg", "human mouth", "human nose",
    "land vehicle", "mammal", "man", "person", "personal care", "plant",
    "plumbing fixture", "seat belt", "skull", "sports equipment", "tire",
    "tree", "vehicle registration plate", "wheel", "woman",
    "__background__",
)

# Class-name spelling normalizations (utils/cbs.py:516-523).
REPLACEMENTS: Dict[str, str] = {
    "band-aid": "bandaid",
    "wood-burning stove": "wood burning stove",
    "kitchen & dining room table": "table",
    "salt and pepper shakers": "salt and pepper",
    "power plugs and sockets": "power plugs",
    "luggage and bags": "luggage",
}


def load_wordforms(path: str) -> Dict[str, List[str]]:
    """word → list of interchangeable forms, from a 2-column TSV
    (utils/cbs.py:435-441)."""
    wordforms: Dict[str, List[str]] = {}
    with open(path, "r") as fp:
        for line in fp:
            parts = line.strip().split("\t")
            wordforms[parts[0]] = parts[1].split(",")
    return wordforms


class ConstraintBoxesReader:
    """Detection annotations keyed by image: ``boxes`` [N, 4], lowercased
    ``class_names``, ``scores`` (utils/cbs.py:444-468)."""

    def __init__(self, boxes_tsvpath: str):
        self._image_key_to_boxes: Dict[str, dict] = {}
        with open(boxes_tsvpath, "r") as fp:
            for line in fp:
                parts = line.strip().split("\t")
                labels = json.loads(parts[1])
                self._image_key_to_boxes[parts[0]] = {
                    "boxes": np.array([b["rect"] for b in labels]),
                    "class_names": [b["class"].lower() for b in labels],
                    "scores": np.array([b["conf"] for b in labels]),
                }

    def __len__(self) -> int:
        return len(self._image_key_to_boxes)

    def __getitem__(self, image_key: str) -> dict:
        if image_key not in self._image_key_to_boxes:
            return {"boxes": np.array([]), "class_names": [],
                    "scores": np.array([])}
        return self._image_key_to_boxes[image_key]


class ClassHierarchy:
    """Open-Images class hierarchy with anytree-equivalent lookups.

    ``data`` is the parsed hierarchy JSON: nodes are dicts with
    ``LabelName`` and optional ``Subcategory`` children (the format
    ConstraintFilter.__read_hierarchy consumes, utils/cbs.py:531-543).
    """

    def __init__(self, data: dict):
        self._preorder: List[Tuple[str, int]] = []   # (label_lower, height)

        def height_of(node: dict) -> int:
            children = node.get("Subcategory", [])
            if not children:
                return 0
            return 1 + max(height_of(c) for c in children)

        def walk(node: dict) -> None:
            self._preorder.append(
                (str(node.get("LabelName", "")).lower(), height_of(node))
            )
            for child in node.get("Subcategory", []):
                walk(child)

        walk(data)

    @classmethod
    def from_json(cls, path: str) -> "ClassHierarchy":
        with open(path) as f:
            return cls(json.load(f))

    def height(self, class_name: str) -> int:
        """Height of the FIRST pre-order node whose label is a substring of
        ``class_name`` — anytree ``findall(...)[0].height`` with the
        reference's ``node.LabelName.lower() in c`` predicate
        (utils/cbs.py:585-590).  Raises like the reference's ``[0]`` on no
        match."""
        for label, height in self._preorder:
            if label in class_name:
                return height
        raise IndexError(f"no hierarchy node matches class {class_name!r}")


class ConstraintFilter:
    """boxes → up-to-k constraint class names (utils/cbs.py:477-630)."""

    def __init__(self, hierarchy: ClassHierarchy,
                 nms_threshold: float = 0.85,
                 max_given_constraints: int = 3):
        self._hierarchy = hierarchy
        self._nms_threshold = nms_threshold
        self._max_given_constraints = max_given_constraints

    def __call__(self, boxes: np.ndarray, class_names: Sequence[str],
                 scores: np.ndarray) -> List[str]:
        # drop zero-score padding boxes + blacklisted classes (:556-566)
        keep = [i for i in range(len(class_names))
                if scores[i] > 0 and class_names[i] not in BLACKLIST]
        boxes = boxes[keep]
        class_names = [class_names[i] for i in keep]
        scores = scores[keep]

        keep = self._nms(boxes, class_names)
        boxes = boxes[keep]
        class_names = [class_names[i] for i in keep]
        scores = scores[keep]

        # top-k by detection confidence, then name replacements (:544-551)
        ranked = sorted(zip(class_names, scores), key=lambda t: -t[1])
        ranked = ranked[: self._max_given_constraints]
        names = [REPLACEMENTS.get(t[0], t[0]) for t in ranked]

        # dedup: same set as the reference's list(set(...)) (:553), but in
        # deterministic first-occurrence order
        seen = set()
        out = []
        for n in names:
            if n not in seen:
                seen.add(n)
                out.append(n)
        return out

    def _nms(self, boxes: np.ndarray, class_names: Sequence[str]) -> List[int]:
        """Exact transcription of utils/cbs.py:575-630 — see module
        docstring for why the keep-condition makes this an identity
        reordering by hierarchy height."""
        if len(class_names) == 0:
            return []
        heights = np.array([self._hierarchy.height(c) for c in class_names])
        score_order = heights.argsort()

        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)

        keep_box_indices: List[int] = []
        while score_order.size > 0:
            current = score_order[0]
            keep_box_indices.append(int(current))

            xx1 = np.maximum(x1[current], x1[score_order[1:]])
            yy1 = np.maximum(y1[current], y1[score_order[1:]])
            xx2 = np.minimum(x2[current], x2[score_order[1:]])
            yy2 = np.minimum(y2[current], y2[score_order[1:]])
            intersection = (np.maximum(0.0, xx2 - xx1 + 1)
                            * np.maximum(0.0, yy2 - yy1 + 1))
            union = areas[current] + areas[score_order[1:]] - intersection

            keep_condition = np.logical_or(
                heights[score_order[1:]] >= heights[current],
                intersection / union <= self._nms_threshold,
            )
            score_order = score_order[1:][np.where(keep_condition)[0]]
        return keep_box_indices


def tokenize_constraints(
    class_names: Sequence[str],
    convert_tokens_to_ids: Callable[[List[str]], List[int]],
    *,
    constraint2tokens: Optional[Dict[str, List[str]]] = None,
    wordforms: Optional[Dict[str, List[str]]] = None,
    max_words_per_constraint: int = 4,
) -> List[List[List[int]]]:
    """Class names → nested [constraint][word][wordform-id] token lists for
    :meth:`generation.fsm.FiniteStateMachineBuilder.build`.

    Replicates the reference builder's expansion: split the class name on
    spaces, map each word through ``constraint2tokens`` (identity when
    absent), cap the word list at ``max_words_per_constraint``
    (utils/cbs.py:774-780), then expand each word to its ``wordforms``
    (default ``[word]``) and convert to ids (:845-847).
    """
    constraint2tokens = constraint2tokens or {}
    wordforms = wordforms or {}
    out: List[List[List[int]]] = []
    for name in class_names:
        words: List[str] = []
        for w in name.split():
            words.extend(constraint2tokens.get(w, [w]))
        words = words[:max_words_per_constraint]
        out.append(
            [convert_tokens_to_ids(wordforms.get(w, [w])) for w in words]
        )
    return out


def boxes_to_constraint_ids(
    boxes: np.ndarray,
    class_names: Sequence[str],
    scores: np.ndarray,
    filter_: ConstraintFilter,
    convert_tokens_to_ids: Callable[[List[str]], List[int]],
    **tokenize_kwargs,
) -> Tuple[List[str], List[List[List[int]]]]:
    """One-call front-end: detections → (selected class names, nested token
    ids ready for ``FiniteStateMachineBuilder.build``)."""
    names = filter_(boxes, class_names, scores)
    return names, tokenize_constraints(
        names, convert_tokens_to_ids, **tokenize_kwargs
    )
