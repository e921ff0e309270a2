"""Precompute frozen-CLIP embeddings into .mcrpack feature stores (port of
the JAX package's ``cli/precompute_clip.py``).

The reference's frozen CLIP (run_PMR_ModCR.py:450; consumed by the
``clip_model``/``clip_model_r`` ablations, modeling_ensemble.py:804-806,
833-835) outputs features, so they are computed once offline with the
towers of models/clip.py and served from the same indexed mmap pack as the
region features; the CLIP ensembles (models/clip_ensemble.py) consume these
[512]-d vectors.  The flags and defaults are the JAX command's, plus
``--device`` (default ``cuda``; without a card the command raises,
``--device cpu`` asks for the CPU).  The packs are byte-compatible with the
JAX command's.

    python -m multimodal_context_reasoning_torch.cli.precompute_clip \\
        --checkpoint ViT-B-16.pt --bpe_vocab bpe_simple_vocab_16e6.txt.gz \\
        --examples_jsonl pmr_data/val-ori.jsonl --images_root vcr_images/ \\
        --out_image_pack clip_img.mcrpack --out_text_pack clip_txt.mcrpack

Image keys are the examples' ``img_id`` ([1, 512] each); text packs store
one [K, 512] block per example keyed by ``total_id``.  Batches are padded to
a static size, as the JAX command pads them for its jitted towers.  The
image side needs PIL and the text side ``regex``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import CLIPConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.clip_preprocess import preprocess_image
from multimodal_context_reasoning_torch.data.clip_tokenizer import ClipTokenizer
from multimodal_context_reasoning_torch.data.feature_store import write_pack
from multimodal_context_reasoning_torch.interop.torch_bridge import (
    convert_clip,
    load_clip_checkpoint,
)
from multimodal_context_reasoning_torch.models.clip import CLIP


def render_plain(tokens, objects) -> str:
    """PMR mixed token/[idx] rows → plain text for CLIP (object names
    without the ``<|det#|>`` markers the BERT towers use — CLIP's BPE
    vocab has no region tokens)."""
    words: List[str] = []
    for tok in tokens:
        if isinstance(tok, list):
            words.append(" and ".join(
                objects[i] if i < len(objects) else "object" for i in tok))
        else:
            words.append(str(tok))
    return " ".join(words)


def _batched(fn, items, batch: int, make_rows=None) -> np.ndarray:
    """Run ``fn`` over ``items`` in static-size batches (the tail padded
    with its last row).  ``make_rows`` materializes one chunk just in time —
    images are ~600 KB/row as f32, so stacking a whole split up front would
    pin GBs of host RAM for nothing."""
    out = []
    for i in range(0, len(items), batch):
        chunk = items[i: i + batch]
        rows = make_rows(chunk) if make_rows is not None else np.asarray(chunk)
        pad = batch - len(rows)
        if pad:
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad, axis=0)], axis=0)
        emb = np.asarray(fn(rows))
        out.append(emb[: batch - pad])
    return np.concatenate(out, axis=0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="CLIP weights: OpenAI ViT-B-16.pt or HF pytorch_model.bin")
    p.add_argument("--bpe_vocab", default="",
                   help="OpenAI bpe_simple_vocab_16e6.txt.gz (text side)")
    p.add_argument("--examples_jsonl", required=True,
                   help="PMR/VCR jsonl with img_id/img_fn/answer_choices")
    p.add_argument("--images_root", default="",
                   help="root dir that img_fn paths resolve against "
                        "(omit to skip the image side)")
    p.add_argument("--out_image_pack", default="")
    p.add_argument("--out_text_pack", default="")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--tiny", action="store_true", help="tiny tower geometry (tests/smoke)")
    p.add_argument("--config_overrides", default="",
                   help="JSON dict of CLIPConfig field overrides, e.g. "
                        '\'{"vocab_size": 600}\' to match a reduced BPE '
                        "table (the model vocab must cover every token id)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CLIPConfig.tiny() if args.tiny else CLIPConfig()
    cfg = dataclasses.replace(
        cfg, dtype=args.dtype,
        **(json.loads(args.config_overrides) if args.config_overrides else {}))
    model = CLIP(cfg, device=device).eval()
    sd = convert_clip(load_clip_checkpoint(args.checkpoint))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)

    def run(tower):
        def fn(rows: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                return tower(torch.from_numpy(rows).to(device)).float().cpu().numpy()
        return fn

    rows = [json.loads(line)
            for line in open(args.examples_jsonl, encoding="utf-8")
            if line.strip()]
    print(f"[precompute-clip] {len(rows)} examples", file=sys.stderr)

    if args.images_root and args.out_image_pack:
        by_img: Dict[str, str] = {}
        for r in rows:
            by_img.setdefault(str(r["img_id"]), r["img_fn"])
        keys = sorted(by_img)
        emb = _batched(
            run(model.encode_image), keys, args.batch,
            make_rows=lambda ks: np.stack([
                preprocess_image(os.path.join(args.images_root, by_img[k]),
                                 cfg.image_size) for k in ks]))
        write_pack({k: emb[i: i + 1].astype(np.float32) for i, k in enumerate(keys)},
                   args.out_image_pack)
        print(f"[precompute-clip] image pack: {len(keys)} ids "
              f"-> {args.out_image_pack}", file=sys.stderr)

    if args.out_text_pack:
        if not args.bpe_vocab:
            raise SystemExit("--out_text_pack needs --bpe_vocab")
        tok = ClipTokenizer(args.bpe_vocab)
        texts, spans = [], []
        for r in rows:
            objects = r.get("objects", [])
            start = len(texts)
            for choice in r["answer_choices"]:
                texts.append(render_plain(choice, objects)
                             if isinstance(choice, list) else str(choice))
            spans.append((str(r.get("total_id", r["img_id"])), start, len(texts)))
        ids = tok.tokenize(texts, cfg.context_length, truncate=True).astype(np.int64)
        emb = _batched(run(model.encode_text), ids, args.batch)
        write_pack({key: emb[a:b].astype(np.float32) for key, a, b in spans},
                   args.out_text_pack)
        print(f"[precompute-clip] text pack: {len(spans)} examples "
              f"-> {args.out_text_pack}", file=sys.stderr)


if __name__ == "__main__":
    main()
