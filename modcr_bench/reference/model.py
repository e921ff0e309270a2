"""The plain fp32 forward pass of the configuration the benchmark runs,
written from the published model (ModCR, Li et al., ACL 2023,
arXiv:2305.04530: ``Abstract_Specific`` in modeling_ensemble.py:424-539;
BERT-base and RoBERTa-large layers as in HuggingFace).

Everything is a plain ``torch`` operation on a dict of parameters keyed by
the reference checkpoints' names: no kernel, no cache, no batching, no
import of the program.  Masks are the reference's dense additive
``(1 - m) * -10000`` biases; softmax, GELU (tanh form) and LayerNorm are
PyTorch's.  Departures from the published code, all shared with the
program under test: the fusion's memory padding is masked
(``mask_fusion_memory``), and the vision prefix runs once per example.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

NEG = -10000.0
Params = Dict[str, torch.Tensor]


class Ref:
    """Parameter access and the building blocks of the model."""

    def __init__(self, params: Params):
        self.P = params

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x @ self.P[name + ".weight"].t() + self.P[name + ".bias"]

    def norm(self, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"], self.P[name + ".bias"], eps)

    def ffn(self, pre: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        h = F.gelu(self.linear(pre + "intermediate.dense", x), approximate="tanh")
        return self.norm(pre + "output.LayerNorm", self.linear(pre + "output.dense", h) + x, eps)

    def embed(self, pre: str, ids, token_types, positions, eps):
        P = self.P
        x = (P[pre + "word_embeddings.weight"][ids] + P[pre + "token_type_embeddings.weight"][token_types]
             + P[pre + "position_embeddings.weight"][positions])
        return self.norm(pre + "LayerNorm", x, eps)

    def layer(self, pre: str, h, bias, heads: int, eps: float, *, prefix=None,
              chunk_ids=None, num_chunks: int = 0):
        """Post-LN BERT layer; ``prefix`` [B, P, D] raw vectors projected by
        this layer's key and value weights ahead of the tokens;
        ``chunk_ids`` [B, L] replaces each in-chunk query by its chunk's
        mean."""
        B, L, D = h.shape
        src = h if prefix is None else torch.cat([prefix, h], dim=1)
        q = self.linear(pre + "attention.self.query", h)
        k = self.linear(pre + "attention.self.key", src)
        v = self.linear(pre + "attention.self.value", src)
        if chunk_ids is not None:
            q = chunk_mean(q, chunk_ids, num_chunks)
        dh = D // heads
        q = q.view(B, L, heads, dh).transpose(1, 2)
        k = k.view(B, -1, heads, dh).transpose(1, 2)
        v = v.view(B, -1, heads, dh).transpose(1, 2)
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + bias, dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(B, L, D)
        a = self.norm(pre + "attention.output.LayerNorm",
                      self.linear(pre + "attention.output.dense", out) + h, eps)
        return self.ffn(pre, a, eps)


def chunk_mean(x: torch.Tensor, ids: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """Each row of ``x`` [B, L, D] whose chunk id is >= 0 becomes the mean
    of its chunk's rows (scatter sums, no products)."""
    B, L, D = x.shape
    inside = ids >= 0
    idx = ids.clamp_min(0)
    sums = x.new_zeros(B, num_chunks, D).scatter_add(
        1, idx[..., None].expand(B, L, D), x * inside[..., None])
    counts = x.new_zeros(B, num_chunks).scatter_add(1, idx, inside.to(x.dtype))
    means = sums / counts.clamp_min(1.0)[..., None]
    return torch.where(inside[..., None], means.gather(1, idx[..., None].expand(B, L, D)), x)


def stage_biases(text_mask, img_mask, gather):
    """(chunk, full, cross) additive biases [B, 1, L, L] / [B, 1, 1, L]:

    - chunk: a text row sees its own chunk, itself, and real regions; the
      CLS row and the last real text row see all real text; padding rows
      see no text; region rows see only real regions;
    - full: every real token;
    - cross: text rows as in chunk; each region row sees only itself."""
    B, T = text_mask.shape
    I = img_mask.shape[1]
    dev = text_mask.device
    same = (gather[:, :, None] == gather[:, None, :]) & (gather[:, :, None] >= 0)
    eye_t = torch.eye(T, dtype=torch.bool, device=dev)[None]
    pos = torch.arange(T, device=dev)[None]
    last = (text_mask > 0).sum(dim=1) - 1
    full_rows = ((pos == 0) | (pos == last[:, None]))[:, :, None]
    real = (text_mask[:, :, None] > 0) & (text_mask[:, None, :] > 0)
    chunk_vis = ((same | full_rows | eye_t) & real).float()
    img_col = ((1.0 - img_mask) * NEG)[:, None, :]
    text_rows = torch.cat([(1.0 - chunk_vis) * NEG, img_col.expand(B, T, I)], dim=-1)
    hard = torch.full((B, I, T), NEG, device=dev)
    chunk = torch.cat([text_rows, torch.cat([hard, img_col.expand(B, I, I)], -1)], 1)
    eye_i = (1.0 - torch.eye(I, device=dev)) * NEG
    cross = torch.cat([text_rows, torch.cat([hard, eye_i[None].expand(B, I, I)], -1)], 1)
    full = ((1.0 - torch.cat([text_mask, img_mask], -1)) * NEG)[:, None, None, :]
    return chunk[:, None], full, cross[:, None]


class EncOut(NamedTuple):
    sequence: torch.Tensor
    pooled: torch.Tensor
    chunk_hidden: Optional[torch.Tensor]


def global_encoder(r: Ref, pre: str, c: Dict, ids, img_feat, mask, token_types=None) -> EncOut:
    """Oscar-base: text embeddings ++ projected regions, full attention
    under the padding mask, tanh pooler over position 0."""
    B, T = ids.shape
    eps = c["layer_norm_eps"]
    tt = torch.zeros_like(ids) if token_types is None else token_types
    pos = torch.arange(T, device=ids.device)[None].expand(B, T)
    h = torch.cat([r.embed(pre + "embeddings.", ids, tt, pos, eps),
                   r.linear(pre + "img_embedding", img_feat)], dim=1)
    bias = ((1.0 - mask) * NEG)[:, None, None, :]
    for i in range(c["num_hidden_layers"]):
        h = r.layer(f"{pre}encoder.layer.{i}.", h, bias, c["num_attention_heads"], eps)
    pooled = torch.tanh(r.linear(pre + "pooler.dense", h[:, 0]))
    return EncOut(h, pooled, None)


def chunkalign_encoder(r: Ref, pre: str, c: Dict, sched: Dict, max_chunks: int, b) -> EncOut:
    """The ChunkAlign encoder: chunk-stage layers, full-stage layers, then
    cross-stage layers whose queries are chunk means; the hidden states
    entering the cross stage are returned too."""
    ids, tm, im = b["input_ids"], b["text_mask"], b["img_mask"]
    B, T = ids.shape
    I = im.shape[1]
    eps = c["layer_norm_eps"]
    pos = torch.arange(T, device=ids.device)[None].expand(B, T)
    h = torch.cat([r.embed(pre + "embeddings.", ids, b["token_type_ids"], pos, eps),
                   r.linear(pre + "img_embedding", b["img_feat"])], dim=1)
    biases = stage_biases(tm, im, b["gather_index"])
    stream_ids = torch.cat([b["gather_index"], torch.full((B, I), -1, dtype=b["gather_index"].dtype,
                                                         device=ids.device)], dim=1)
    chunk_hidden = None
    for i in range(c["num_hidden_layers"]):
        cross = i >= sched["full_layers_end"]
        stage = 0 if i < sched["chunk_layers_end"] else (2 if cross else 1)
        if i == sched["full_layers_end"]:
            chunk_hidden = h
        h = r.layer(f"{pre}encoder.layer.{i}.", h, biases[stage], c["num_attention_heads"],
                    eps, chunk_ids=stream_ids if cross else None, num_chunks=max_chunks)
    pooled = torch.tanh(r.linear(pre + "pooler.dense", h[:, 0]))
    return EncOut(h, pooled, chunk_hidden)


def mapping(r: Ref, pre: str, x, prefix_len: int, out: int):
    return r.linear(pre + ".4", torch.tanh(r.linear(pre + ".1", x))).view(x.shape[0], prefix_len, out)


def roberta(r: Ref, c: Dict, ids, attn_mask, prefix):
    """Prefix-KV RoBERTa: the prefix is projected by each layer's own key
    and value weights; positions count from pad_token_id + 1."""
    pad, eps = c["pad_token_id"], c["layer_norm_eps"]
    keep = (ids != pad).long()
    pos = torch.cumsum(keep, dim=1) * keep + pad
    h = r.embed("roberta.embeddings.", ids, torch.zeros_like(ids), pos, eps)
    kv_mask = torch.cat([torch.ones(prefix.shape[:2], device=ids.device), attn_mask], dim=-1)
    bias = ((1.0 - kv_mask) * NEG)[:, None, None, :]
    for i in range(c["num_hidden_layers"]):
        h = r.layer(f"roberta.encoder.layer.{i}.", h, bias, c["num_attention_heads"], eps,
                    prefix=prefix)
    return torch.tanh(r.linear("roberta.pooler.dense", h[:, 0]))


def modcr_forward(r: Ref, m: Dict, b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """ModCR's 4-way logits [Q, K].  The vision prefix is computed once per
    question and repeated for its candidates, as the program does."""
    ge, se, sc, rc = m["global_encoder"], m["seq_encoder"], m["chunkalign"], m["roberta"]
    K, T = m["num_labels"], b["input_ids"].shape[1]
    ids, tm, im, feat = b["input_ids"], b["text_mask"], b["img_mask"], b["img_feat"]
    rows = slice(None, None, K)
    vis = global_encoder(r, "calec.global_enc.", ge, ids[rows, :1], feat[rows],
                         torch.cat([tm[rows, :1], im[rows]], -1))
    p_vis = mapping(r, "mapping_network_vision", vis.sequence[:, 0], m["prefix_len"],
                    rc["hidden_size"]).repeat_interleave(K, dim=0)
    g = global_encoder(r, "calec.global_enc.", ge, ids, feat, torch.cat([tm, im], -1),
                       b["token_type_ids"])
    s = chunkalign_encoder(r, "calec.seq_enc.", se, sc, m["max_chunks"], b)
    cls = r.linear("calec.cls_ensemble_1", torch.cat([g.pooled, s.pooled], -1))
    memory = torch.cat([g.sequence[:, 1:T], s.sequence[:, 1:T], s.chunk_hidden[:, 1:T]], dim=1)
    word = tm[:, 1:T]
    mbias = ((1.0 - torch.cat([word, word, word], -1)) * NEG)[:, None, None, :]
    heads = sc["cls_num_heads"]
    B, M, D = memory.shape
    dh = D // heads
    for i in range(sc["cls_layer_num"]):
        pre = f"calec.cls_layer_lyx.{i}."
        q = r.linear(pre + "cross_attention.q_proj", cls[:, None]).view(B, 1, heads, dh).transpose(1, 2)
        k = r.linear(pre + "cross_attention.k_proj", memory).view(B, M, heads, dh).transpose(1, 2)
        v = r.linear(pre + "cross_attention.v_proj", memory).view(B, M, heads, dh).transpose(1, 2)
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + mbias, dim=-1)
        o = r.linear(pre + "cross_attention.out_proj", (p @ v).transpose(1, 2).reshape(B, D))
        cls = r.ffn(pre, r.norm(pre + "LayerNorm", o + cls, se["layer_norm_eps"]), se["layer_norm_eps"])
    p_align = mapping(r, "mapping_network_alignment", cls, m["prefix_len"], rc["hidden_size"])
    pooled = roberta(r, rc, b["r_input_ids"], b["r_attention_mask"], torch.cat([p_vis, p_align], 1))
    return r.linear("abst_confidence_scorer", pooled).view(-1, K)
