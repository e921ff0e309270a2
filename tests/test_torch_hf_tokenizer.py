"""PyTorch port, HuggingFace tokenizer directories: ``HFTokenizer`` and the
``--bert_tokenizer_dir`` / ``--roberta_tokenizer_dir`` / ``--gpt_tokenizer_dir``
flags, held against the JAX package.

The tokenizer is a tiny ``BertTokenizerFast`` over a handcrafted WordPiece
vocab (as JAX tests/test_tokenization.py builds one) saved with
``save_pretrained`` and read back through ``AutoTokenizer`` offline.  Ids,
lengths and special tokens must equal the JAX adapter's, and ``run_pmr
--do_test`` with both directories must write the JAX CLI's prediction file.
``build_chunk_masks --chunker_dir --bert_tokenizer_dir`` (both formats) must
write the JAX tool's pickle, with the local chunker a tiny random
``BertForTokenClassification`` built as JAX tests/test_chunker_parity.py
builds it (these need ``transformers``, so they live here rather than in
tests/test_torch_tools.py).
"""

import pickle

import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.cli import build_chunk_masks as jchunks
from multimodal_context_reasoning_tpu.cli import run_pmr as jrun_pmr
from multimodal_context_reasoning_tpu.data.tokenization import HFTokenizer as JHF
from multimodal_context_reasoning_torch.cli import build_chunk_masks as tchunks
from multimodal_context_reasoning_torch.cli import run_pmr as trun_pmr
from multimodal_context_reasoning_torch.cli import serve as tserve_cli
from multimodal_context_reasoning_torch.data.rationale import B_RTNL, E_RTNL
from multimodal_context_reasoning_torch.data.schemas import RawExample
from multimodal_context_reasoning_torch.data.tokenization import (
    HFTokenizer,
    hf_tokenizer_from_dir,
)
from multimodal_context_reasoning_torch.serving import server as tserver
from multimodal_context_reasoning_torch.serving.synthetic import WORDS
from tests.test_torch_cli import (  # noqa: F401
    _jax_argv,
    _port_argv,
    _predictions,
    data,
    tiny_without_mapping_dropout,
)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "the", ".", ",", "##s",
         "##gy", "smiles", *WORDS]
SENTENCES = ["a doggy man <|det3|> smiles .", "the woman holds a cup near the table .",
             "<|det0|> <|det44|> dogs walks , cars", "UNSEEN words Stay unk ."]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the test off the cores the other workers
    use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def transformers():
    """Imported here, not at collection: every test worker collects every
    file, and importing transformers takes about 10 s."""
    return pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def tok_dir(transformers, tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_tok")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    hf = transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"), do_lower_case=True)
    hf.save_pretrained(str(d / "bert"))
    # a GPT-side tokenizer holding the rationale markers (no det tokens)
    hf.add_special_tokens({"additional_special_tokens": [B_RTNL, E_RTNL]})
    hf.save_pretrained(str(d / "gpt"))
    return d


@pytest.mark.parametrize("text", SENTENCES)
def test_hf_tokenizer_ids_equal_jax(transformers, tok_dir, text):
    path = str(tok_dir / "bert")
    got = hf_tokenizer_from_dir(path, "--bert_tokenizer_dir")
    want = JHF(transformers.AutoTokenizer.from_pretrained(path))
    assert got.tokenize(text) == want.tokenize(text)
    assert (got.convert_tokens_to_ids(got.tokenize(text))
            == want.convert_tokens_to_ids(want.tokenize(text)))
    assert len(got) == len(want) == len(VOCAB) + 45
    assert (got.cls_token, got.sep_token, got.pad_id) == (want.cls_token, want.sep_token,
                                                          want.pad_id)


def test_adapter_without_det_tokens_keeps_the_vocabulary(transformers, tok_dir):
    hf = transformers.AutoTokenizer.from_pretrained(str(tok_dir / "gpt"))
    tok = HFTokenizer(hf, add_det_tokens=False)
    assert len(tok) == len(VOCAB) + 2
    assert tok.convert_tokens_to_ids([B_RTNL, E_RTNL]) == [len(VOCAB), len(VOCAB) + 1]


def test_run_pmr_with_tokenizer_dirs_writes_the_jax_predictions(data, tok_dir):
    path = str(tok_dir / "bert")
    flags = ["--do_test", "--test_file", data["paths"]["test"],
             "--bert_tokenizer_dir", path, "--roberta_tokenizer_dir", path]
    jrun_pmr.main(_jax_argv(data, "jax_hf", *flags))
    trun_pmr.main(_port_argv(data, "port_hf", *flags))
    got, want = _predictions(data, "port_hf"), _predictions(data, "jax_hf")
    assert got == want and len(got) == 6


def test_serve_generates_with_a_gpt_tokenizer_dir(data, tok_dir, monkeypatch):
    """/generate decodes through the directory's tokenizer: its marker ids,
    and text in the reply (the hash tokenizer gives ids only)."""
    captured = {}
    monkeypatch.setattr(tserver, "serve",
                        lambda scorer, host, port, **kw: captured.update(kw))
    tserve_cli.main(["--img_feat_file", data["paths"]["pkl"], "--device", "cpu", "--tiny",
                     "--compute_dtype", "float32", "--generate", "--gen_micro_batch", "1",
                     "--max_rationale_len", "4", "--gpt_tokenizer_dir", str(tok_dir / "gpt"),
                     "--bert_tokenizer_dir", str(tok_dir / "bert")])
    gen = captured["generator"]
    assert (gen.b_rtnl, gen.e_rtnl) == (len(VOCAB), len(VOCAB) + 1)
    img = sorted(gen.features)[0]
    out = gen.generate([RawExample(example_id="q", img_id=img, premise="a man smiles .",
                                   answer_choices=["a dog ."] * 4, answer_label=0)])
    assert "rationale_text" in out[0] and np.all(np.asarray(out[0]["rationale_ids"]) >= 0)


@pytest.fixture(scope="module")
def chunker_dir(transformers, tmp_path_factory):
    """A tiny random HF token-classification checkpoint on disk, as JAX
    tests/test_chunker_parity.py:138-158 builds it."""
    d = tmp_path_factory.mktemp("chunker")
    labels = ["O", "B-NP", "I-NP", "B-VP", "I-VP", "B-PP", "I-PP"]
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    tok = transformers.BertTokenizerFast(str(d / "vocab.txt"), do_lower_case=True)
    tok.save_pretrained(str(d))
    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=len(tok), hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=64, num_labels=len(labels),
        id2label=dict(enumerate(labels)), label2id={lab: i for i, lab in enumerate(labels)})
    transformers.BertForTokenClassification(cfg).save_pretrained(str(d))
    return str(d)


def test_chunker_tags_equal_jax(chunker_dir):
    tokens = ["the", "dog", "holds", "a", "cup", "zzz-unk-zzz"]
    got = tchunks.make_hf_tag_fn(chunker_dir)(tokens)
    assert got == jchunks.make_hf_tag_fn(chunker_dir)(tokens) and len(got) == 6


@pytest.mark.parametrize("fmt", ["gather", "reference"])
def test_build_chunk_masks_with_a_chunker_dir_writes_the_jax_pickle(
        data, tok_dir, chunker_dir, tmp_path, fmt):
    out = {}
    for name, tool in (("jax", jchunks), ("port", tchunks)):
        path = tmp_path / f"{name}.pkl"
        tool.main(["--examples", data["paths"]["test"], "--format", fmt, "--out", str(path),
                   "--chunker_dir", chunker_dir, "--bert_tokenizer_dir", str(tok_dir / "bert")])
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    got, want = out["port"], out["jax"]
    assert list(got) == list(want) and len(got) == 6
    for idx in want:
        for g, w in zip(got[idx], want[idx], strict=True):
            if fmt == "gather":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_array_equal(g["mask"], w["mask"])
                assert g["offsets"] == w["offsets"]
