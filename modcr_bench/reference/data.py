"""Plain featurization of PMR examples: the hash tokenizers, the heuristic
phrase chunker, the prompt templates and the fixed-shape collate, written
out again from the reference dataset's recipe (Data/VCRChunkAlign.py:
529-688) so that the reference re-derives every model input from the raw
examples and features.  Numpy only; nothing of the program is imported.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence

import numpy as np

NUM_DET_TOKENS = 45
_DET_RE = re.compile(r"<\|det(\d+)\|>")
_BOUNDARY = {
    "a", "an", "the", "and", "or", "but", "if", "of", "in", "on", "at", "to",
    "for", "with", "by", "from", "as", "is", "are", "was", "were", "be",
    "been", "being", "will", "would", "can", "could", "should", "that",
    "this", "these", "those", "it", "its", "他", "她",
}
_PUNCT = set(".,!?;:'\"()[]{}")
PROMPT_TEXT = (
    "Is Answer correct or wrong based on the Conditions? Conditions: "
    "Image Description is <mask>, Bridge between Image and the following "
    "texts is <mask>, Premise Text is "
)
ANSWER_PREFIX = "Answer is "
BERT_PAD, ROBERTA_PAD = 0, 1


class HashTokenizer:
    """Whitespace-and-punctuation tokens hashed (md5) into the vocabulary
    below the 45 ``<|det#|>`` ids at its top; [CLS]=1, [SEP]=2, <mask>=3
    (RoBERTa: <s>=0, </s>=2, pad 1)."""

    def __init__(self, vocab_size: int, roberta: bool = False):
        self.vocab_size = vocab_size
        self.cls, self.sep = ("<s>", "</s>") if roberta else ("[CLS]", "[SEP]")
        self.special = {self.cls: 0 if roberta else 1, self.sep: 2, "<mask>": 3}
        base = vocab_size - NUM_DET_TOKENS
        for i in range(NUM_DET_TOKENS):
            self.special[f"<|det{i}|>"] = base + i

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for piece in text.strip().split():
            if _DET_RE.fullmatch(piece):
                out.append(piece)
            else:
                out.extend(re.findall(r"<\|det\d+\|>|\w+|[^\w\s]", piece.lower()))
        return out

    def ids(self, tokens: Sequence[str]) -> List[int]:
        span = self.vocab_size - NUM_DET_TOKENS - 4
        out = []
        for t in tokens:
            if t in self.special:
                out.append(self.special[t])
            else:
                h = int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "little")
                out.append(4 + h % span)
        return out


def bio_tags(tokens: Sequence[str]) -> List[str]:
    """Content-word runs are phrases; punctuation and function words are O."""
    tags, in_phrase = [], False
    for tok in tokens:
        t = tok.lower().lstrip("##")
        if t in _PUNCT or t in _BOUNDARY:
            tags.append("O")
            in_phrase = False
        elif tok.startswith("##") and in_phrase:
            tags.append("I")
        else:
            tags.append("I" if in_phrase else "B")
            in_phrase = True
    return tags


def chunks(tags: Sequence[str]) -> List[List[int]]:
    """The reference chunking script's grouping loop (GetChunk_v4_vcr.py:
    117-141): B opens a chunk, I extends (or opens) it, an O followed by I
    is bridged into the open chunk, a lone O leaves it open."""
    out: List[List[int]] = []
    cur: List[int] = []
    n = len(tags)
    for i, tag in enumerate(tags):
        head = tag[0].upper() if tag else "O"
        if head == "B":
            if cur:
                out.append(cur)
            cur = [i]
        elif head == "I":
            cur.append(i)
        elif i != n - 1 and cur and tags[i + 1][:1].upper() == "I":
            cur.append(i)
    if cur:
        out.append(cur)
    return out


def gather_index(interior: Sequence[str], total_len: int, max_chunks: int) -> np.ndarray:
    """Chunk id of each position of [CLS] interior [SEP]; -1 outside."""
    out = np.full((total_len,), -1, np.int32)
    for cid, members in enumerate(chunks(bio_tags(interior))[:max_chunks]):
        for pos in members:
            if pos + 1 < total_len:
                out[pos + 1] = cid
    return out


def _target(label, k: int) -> float:
    if label is None:
        return 0.0
    if isinstance(label, (list, tuple)):
        return 1.0 if k in label else 0.0
    return 1.0 if k == label else 0.0


def featurize(ex, bert: HashTokenizer, rob: HashTokenizer, geo: Dict) -> List[Dict]:
    """One example -> one dict per candidate (unpadded)."""
    premise = bert.tokenize(ex.premise.lower())
    r_que = rob.tokenize(PROMPT_TEXT + ex.premise.lower())
    rows = []
    for k, ans in enumerate(ex.answer_choices):
        toks = ([bert.cls] + premise + [bert.sep] + bert.tokenize(ans) + [bert.sep])
        toks = toks[:geo["text_len"]]
        t = len(toks)
        tt = np.zeros((t,), np.int32)
        tt[min(len(premise) + 2, t):] = 1
        total = np.zeros((t,), np.int32)
        for pos, tok in enumerate(toks):
            m = _DET_RE.fullmatch(tok)
            if m:
                total[pos] = int(m.group(1))
        r_toks = ([rob.cls] + r_que + [rob.sep]
                  + rob.tokenize(ANSWER_PREFIX + " ".join(ans.split(" , "))) + [rob.sep])
        r_toks = r_toks[:geo["roberta_len"]]
        rows.append(dict(
            input_ids=np.asarray(bert.ids(toks), np.int32), token_type_ids=tt,
            gather_index=gather_index(toks[1:t - 1] if t >= 2 else [], t, geo["max_chunks"]),
            total_label=total, align_pos=(total != 0).astype(np.int32),
            r_input_ids=np.asarray(rob.ids(r_toks), np.int32), target=_target(ex.answer_label, k),
        ))
    return rows


def collate(examples: Sequence, feats: Dict[str, np.ndarray], geo: Dict) -> Dict[str, np.ndarray]:
    """Examples -> the flat [examples x num_labels] padded batch."""
    bert = HashTokenizer(geo["bert_vocab"])
    rob = HashTokenizer(geo["roberta_vocab"], roberta=True)
    K, T, I, R = geo["num_labels"], geo["text_len"], geo["img_len"], geo["roberta_len"]
    N = len(examples) * K
    out = {
        "input_ids": np.full((N, T), BERT_PAD, np.int64),
        "token_type_ids": np.zeros((N, T), np.int64),
        "text_mask": np.zeros((N, T), np.float32),
        "gather_index": np.full((N, T), -1, np.int64),
        "total_label": np.zeros((N, T), np.int64),
        "align_pos": np.zeros((N, T), np.float32),
        "r_input_ids": np.full((N, R), ROBERTA_PAD, np.int64),
        "r_attention_mask": np.zeros((N, R), np.float32),
        "img_feat": np.zeros((N, I, geo["img_feature_dim"]), np.float32),
        "img_mask": np.zeros((N, I), np.float32),
        "label": np.zeros((N,), np.float32),
    }
    for b, ex in enumerate(examples):
        img = feats[ex.img_id]
        n_reg = min(img.shape[0], I)
        for k, row in enumerate(featurize(ex, bert, rob, geo)):
            n = b * K + k
            t, r = len(row["input_ids"]), len(row["r_input_ids"])
            out["input_ids"][n, :t] = row["input_ids"]
            out["token_type_ids"][n, :t] = row["token_type_ids"]
            out["text_mask"][n, :t] = 1.0
            out["gather_index"][n, :t] = row["gather_index"]
            out["total_label"][n, :t] = row["total_label"]
            out["align_pos"][n, :t] = row["align_pos"]
            out["r_input_ids"][n, :r] = row["r_input_ids"]
            out["r_attention_mask"][n, :r] = 1.0
            out["img_feat"][n, :n_reg] = img[:n_reg]
            out["img_mask"][n, :n_reg] = 1.0
            out["label"][n] = row["target"]
    return out
