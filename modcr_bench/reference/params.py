"""Names and shapes of the model's parameters, from the configuration
alone: the reference checkpoint's keys (HuggingFace BERT / RoBERTa layout,
``calec.*`` and ``mapping_network_*`` of ModCR)."""

from __future__ import annotations

from typing import Dict, List, Tuple

Shapes = List[Tuple[str, Tuple[int, ...]]]


def _linear(name: str, i: int, o: int) -> Shapes:
    return [(name + ".weight", (o, i)), (name + ".bias", (o,))]


def _norm(name: str, d: int) -> Shapes:
    return [(name + ".weight", (d,)), (name + ".bias", (d,))]


def _ffn(pre: str, d: int, f: int) -> Shapes:
    return (_linear(pre + "intermediate.dense", d, f) + _linear(pre + "output.dense", f, d)
            + _norm(pre + "output.LayerNorm", d))


def _embeddings(pre: str, c: Dict) -> Shapes:
    d = c["hidden_size"]
    return [(pre + "word_embeddings.weight", (c["vocab_size"], d)),
            (pre + "position_embeddings.weight", (c["max_position_embeddings"], d)),
            (pre + "token_type_embeddings.weight", (c["type_vocab_size"], d))] + _norm(pre + "LayerNorm", d)


def _layers(pre: str, c: Dict) -> Shapes:
    d, out = c["hidden_size"], []
    for i in range(c["num_hidden_layers"]):
        p = f"{pre}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            out += _linear(p + "attention.self." + n, d, d)
        out += _linear(p + "attention.output.dense", d, d) + _norm(p + "attention.output.LayerNorm", d)
        out += _ffn(p, d, c["intermediate_size"])
    return out


def encoder(pre: str, c: Dict, *, edge: bool) -> Shapes:
    """An Oscar-base tower; the ChunkAlign tower also holds the unused
    ``edge_dense`` embedding of the reference checkpoint."""
    d = c["hidden_size"]
    out = (_embeddings(pre + "embeddings.", c) + _linear(pre + "img_embedding", c["img_feature_dim"], d)
           + _layers(pre, c) + _linear(pre + "pooler.dense", d, d))
    if edge:
        out.append((pre + "edge_dense.weight", (1, d)))
    return out


def modcr(m: Dict) -> Shapes:
    ge, se, sc, rc = m["global_encoder"], m["seq_encoder"], m["chunkalign"], m["roberta"]
    d, dr, p = ge["hidden_size"], rc["hidden_size"], m["prefix_len"]
    out = _linear("calec.cls_ensemble_1", 2 * d, d)
    for i in range(sc["cls_layer_num"]):
        pre = f"calec.cls_layer_lyx.{i}."
        out += _ffn(pre, d, ge["intermediate_size"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _linear(pre + "cross_attention." + n, d, d)
        out += _norm(pre + "LayerNorm", d)
    out += encoder("calec.global_enc.", ge, edge=False) + encoder("calec.seq_enc.", se, edge=True)
    out += _embeddings("roberta.embeddings.", rc) + _layers("roberta.", rc)
    out += _linear("roberta.pooler.dense", dr, dr)
    for net in ("mapping_network_vision", "mapping_network_alignment"):
        out += _linear(net + ".1", d, d * p) + _linear(net + ".4", d * p, dr * p)
    return out + _linear("abst_confidence_scorer", dr, 1)


SHAPES = {"modcr": modcr}
