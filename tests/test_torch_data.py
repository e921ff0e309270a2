"""PyTorch port, the data modules of the commands: ``data/subword.py``,
``data/feature_store.py`` and ``data/vcr.py`` held against the JAX
package's on files the test writes: the same tokens and ids, the same
trained vocab, the same packed features, the same VCR examples."""

import collections
import dataclasses
import json

import numpy as np
import pytest

from multimodal_context_reasoning_tpu.data import feature_store as jfs
from multimodal_context_reasoning_tpu.data import subword as jsw
from multimodal_context_reasoning_tpu.data import vcr as jvcr
from multimodal_context_reasoning_torch.data import feature_store as tfs
from multimodal_context_reasoning_torch.data import subword as tsw
from multimodal_context_reasoning_torch.data import vcr as tvcr
from multimodal_context_reasoning_torch.serving.synthetic import task_rows, write_rows

CORPUS = [
    "A man is wearing a RED hat, and he's smiling!",
    "Why is <|det3|> pointing at <|det12|> ? the dog runs after the runner .",
    "naïve café — résumé…  (weird\tspacing)\n",
    "the jumping dog jumped over <|det0|> and <|det1|> near the running man",
    "numbers 1234 and 3.14159, $5.00!!",
    "汉字 mixed with English words",
    "Is Answer correct or wrong based on the Conditions? Image Description is <mask>",
    "",
]


def _both(fn_name, *args, **kw):
    return getattr(jsw, fn_name)(*args, **kw), getattr(tsw, fn_name)(*args, **kw)


def _same_tokens_and_ids(j_tok, t_tok, texts=CORPUS):
    assert len(t_tok) == len(j_tok)
    assert (t_tok.cls_token, t_tok.sep_token, t_tok.pad_id) == (
        j_tok.cls_token, j_tok.sep_token, j_tok.pad_id)
    for text in texts:
        toks = t_tok.tokenize(text)
        assert toks == j_tok.tokenize(text), text
        assert t_tok.convert_tokens_to_ids(toks) == j_tok.convert_tokens_to_ids(toks), text


@pytest.mark.parametrize("style", ["bert", "roberta"])
def test_corpus_wordpiece_matches_jax(tmp_path, style):
    """``train_wordpiece`` gives the same vocab, and the tokenizers the same
    tokens and ids, before and after a save and reload of the vocab file
    (the roberta style splits ``<mask>``, as the JAX copy does)."""
    texts = CORPUS * 3
    j_vocab, t_vocab = _both("train_wordpiece", texts, vocab_size=120)
    assert t_vocab == j_vocab and len(t_vocab) > 60
    j_tok, t_tok = _both("corpus_wordpiece_tokenizer", texts, vocab_size=120, style=style)
    _same_tokens_and_ids(j_tok, t_tok)
    path = str(tmp_path / "vocab.txt")
    t_tok.save_vocab_file(path)
    load = "from_vocab_file" if style == "bert" else "from_roberta_style_vocab_file"
    _same_tokens_and_ids(getattr(jsw.WordPieceTokenizer, load)(path),
                         getattr(tsw.WordPieceTokenizer, load)(path))
    if style == "roberta":
        assert "<mask>" not in t_tok.tokenize("is <mask> ,")


def _bpe_files(tmp_path, merges_wanted=60):
    """A byte-level BPE vocab.json + merges.txt learnt from the corpus by
    greedy most-frequent-pair merging."""
    enc = jsw.bytes_to_unicode()
    words = collections.Counter(
        "".join(enc[b] for b in piece.encode("utf-8"))
        for text in CORPUS for piece in text.replace("<|", " ").split(" ") if piece)
    seqs = {w: list(w) for w in words}
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>", "<mask>"])}
    for ch in enc.values():
        vocab.setdefault(ch, len(vocab))
    merges = []
    for _ in range(merges_wanted):
        pairs = collections.Counter()
        for w, syms in seqs.items():
            for pair in zip(syms, syms[1:]):
                pairs[pair] += words[w]
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        for w, syms in seqs.items():
            i, out = 0, []
            while i < len(syms):
                if i + 1 < len(syms) and (syms[i], syms[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            seqs[w] = out
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def test_byte_bpe_matches_jax(tmp_path):
    vocab, merges = _bpe_files(tmp_path)
    j_tok = jsw.ByteBPETokenizer.from_files(vocab, merges)
    t_tok = tsw.ByteBPETokenizer.from_files(vocab, merges)
    _same_tokens_and_ids(j_tok, t_tok)
    assert "<|det12|>" in t_tok.tokenize(CORPUS[1])        # det tokens stay atomic
    assert any(len(t) > 1 for t in t_tok.tokenize(CORPUS[0]))   # merges applied


def test_bert_vocab_file_matches_jax(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "dog", "run", "##s",
             "##ning", "man", "a", "is", ",", ".", "!", "?"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    _same_tokens_and_ids(jsw.WordPieceTokenizer.from_vocab_file(str(path)),
                         tsw.WordPieceTokenizer.from_vocab_file(str(path)),
                         CORPUS + ["the dog runs , a man is running !"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_packs_read_the_same_in_both(tmp_path, writer):
    """A pack written by either package reads back bit-equal through both
    readers (the JAX one on its Python path), ragged region counts
    included."""
    rng = np.random.default_rng(0)
    feats = {f"img-{i}": rng.standard_normal((int(rng.integers(1, 9)), 12), dtype=np.float32)
             for i in range(20)}
    path = str(tmp_path / "f.mcrpack")
    (jfs if writer == "jax" else tfs).write_pack(feats, path)
    readers = (jfs.FeatureStore(path, prefer_native=False), tfs.FeatureStore(path))
    for store in readers:
        assert store.dim == 12 and len(store) == 20 and set(store.keys()) == set(feats)
        assert "img-3" in store and "img-99" not in store
        for key, want in feats.items():
            got = store[key]
            assert got.num_regions == want.shape[0] and np.array_equal(got.features, want)
        with pytest.raises(KeyError):
            store["img-99"]
        store.close()
    with open(path, "rb") as f:
        packed = f.read()
    other = str(tmp_path / "g.mcrpack")
    (tfs if writer == "jax" else jfs).write_pack(feats, other)
    with open(other, "rb") as f:
        assert f.read() == packed


def test_vcr_loader_and_truncation_match_jax(tmp_path):
    rows = task_rows(np.random.default_rng(1), 6, 10, vcr=True)
    del rows[0]["answer_label"]                    # defaults to 0
    path = str(tmp_path / "vcr.json")
    write_rows(path, rows)
    with open(path, "a") as f:
        f.write("\n")                              # blank lines are skipped
    for limit in (None, 4):
        want = [dataclasses.asdict(e) for e in jvcr.load_vcr_json(path, limit=limit)]
        assert [dataclasses.asdict(e) for e in tvcr.load_vcr_json(path, limit=limit)] == want
    assert tvcr.load_vcr_json(path)[0].answer_label == 0
    for ans, r_ans in (("a b c", "a b c"), ("x y " + " ".join("t" * 20), "x y"),
                       ("no match here", "zz"), ("text", "")):
        assert tvcr.truncate_answer(ans, r_ans) == jvcr.truncate_answer(ans, r_ans)
