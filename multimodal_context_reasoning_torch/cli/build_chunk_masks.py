"""Offline phrase-chunk preprocessing (port of the JAX package's
``cli/build_chunk_masks.py``; utils/GetChunk_v4_vcr.py parity).

The reference tags B/I/O phrase chunks with a BERT + AdapterHub CoNLL-2000
chunking adapter (:20-22) and pickles per-candidate ``{mask, offsets}``
dicts (:149-159).  This tool produces both formats from raw PMR/VCR files:

- ``--format gather`` (default): compact per-candidate ``gather_index``
  arrays (chunk id per token position), the framework's own input; the
  dense [T, T] mask is built on the device.
- ``--format reference``: the reference's ``{idx: [{mask, offsets}, ×4]}``
  pickle, for byte-level parity runs against the original pipeline.

Tagging: a local HF token-classification chunker when ``--chunker_dir`` is
given (no hub access), the dependency-free heuristic tagger otherwise
(data/chunker.py).  ``--bert_tokenizer_dir`` tokenizes through
``HFTokenizer``; ``transformers`` is imported only for these two flags.

Usage::

    python -m multimodal_context_reasoning_torch.cli.build_chunk_masks \\
        --examples pmr_data/val-ori.jsonl --out val_chunks.pkl
"""

from __future__ import annotations

import argparse
import pickle
from typing import List

import numpy as np

from multimodal_context_reasoning_torch.data.chunker import (
    HeuristicChunker,
    reference_mask_and_offsets,
)
from multimodal_context_reasoning_torch.data.pmr import load_pmr_jsonl
from multimodal_context_reasoning_torch.data.tokenization import (
    HashTokenizer,
    hf_tokenizer_from_dir,
    import_transformers,
)
from multimodal_context_reasoning_torch.data.vcr import load_vcr_json


def dense_mask_from_offsets(offsets: List[List[int]], length: int) -> np.ndarray:
    """Reference mask structure (GetChunk_v4_vcr.py:104-148): eye base,
    chunk blocks, and all-visible ROWS for CLS (0) and the final SEP
    (length-1) — the reference script never sets their columns."""
    m = np.eye(length, dtype=np.float32)
    m[0, :] = 1.0
    m[length - 1, :] = 1.0
    for members in offsets:
        for a in members:
            for b in members:
                if a < length and b < length:
                    m[a, b] = 1.0
    return m


def make_hf_tag_fn(chunker_dir: str):
    """BIO tagger from a local HF token-classification checkpoint.

    Reference path (GetChunk_v4_vcr.py:20-22,93-96): the script feeds its
    OWN wordpiece ids straight into BERT + the CoNLL-2000 chunking adapter
    and argmaxes per-position logits — no re-tokenization.  We do the same:
    tokens are converted with the chunker's tokenizer (unknown pieces → UNK)
    and per-position labels come from ``config.id2label``; the model runs
    on the CPU.
    """
    import torch

    transformers = import_transformers("--chunker_dir")
    model = transformers.AutoModelForTokenClassification.from_pretrained(chunker_dir)
    model.eval()
    ctok = transformers.AutoTokenizer.from_pretrained(chunker_dir)
    id2label = model.config.id2label
    unk = ctok.unk_token_id if ctok.unk_token_id is not None else 0

    def tag_fn(tokens):
        ids = [i if i is not None else unk for i in ctok.convert_tokens_to_ids(list(tokens))]
        with torch.no_grad():
            logits = model(torch.tensor([ids])).logits[0]
        return [str(id2label[int(c)]) for c in logits.argmax(-1).tolist()]

    return tag_fn


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--examples", required=True, help="PMR/VCR jsonl file")
    p.add_argument("--task", choices=("pmr", "vcr"), default="pmr")
    p.add_argument("--out", required=True)
    p.add_argument("--format", choices=("gather", "reference"), default="gather")
    p.add_argument("--chunker_dir", default="",
                   help="local HF token-classification chunker (optional)")
    p.add_argument("--bert_tokenizer_dir", default="")
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args(argv)

    load = load_pmr_jsonl if args.task == "pmr" else load_vcr_json
    examples = load(args.examples, limit=args.limit or None)

    tok = (hf_tokenizer_from_dir(args.bert_tokenizer_dir, "--bert_tokenizer_dir")
           if args.bert_tokenizer_dir else HashTokenizer())
    tag_fn = make_hf_tag_fn(args.chunker_dir) if args.chunker_dir else None

    chunker = HeuristicChunker(tag_fn)
    out = {}
    for idx, ex in enumerate(examples):
        per_candidate = []
        premise_toks = tok.tokenize(ex.premise.lower())
        for ans in ex.answer_choices:
            ans_toks = tok.tokenize(ans)
            toks = [tok.cls_token] + premise_toks + [tok.sep_token] + ans_toks + [tok.sep_token]
            L = len(toks)
            body = toks[1:L - 1]
            if args.format == "reference":
                mask, offsets = reference_mask_and_offsets(chunker.tag_fn(body))
                per_candidate.append({"mask": mask, "offsets": offsets})
            else:
                per_candidate.append(chunker.gather_index(body, offset=1, total_len=L))
        out[idx] = per_candidate

    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {len(out)} examples x {len(next(iter(out.values())))} "
          f"candidates to {args.out} ({args.format} format)")


if __name__ == "__main__":
    main()
