"""PyTorch port: the Oscar task heads (``models/oscar_heads.py``), the task
processors (``data/task_processors.py``), ``data/mixed.py::MixedDataset``,
``serving/synthetic.py::synthetic_features`` and the reasoning layers'
non-production options (``ClsReasonLayer`` ``tau`` / ``neg``,
``ClsLayerLyx`` ``tau`` / ``neg_type`` / ``prior_score``), each held against
its JAX twin on the CPU with the same numpy inputs and weights (carried by
``interop/from_jax.py::oscar_heads_params_from_jax`` for the heads).

Tolerance: fp32 values within 2e-4 abs/rel (the port tests' bound); the
processors' examples, the mixtures' batches and the synthetic features
exactly.  The JAX twins are tests/test_{heads_and_processors,mixed}.py.
"""

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import EncoderConfig as JEnc
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import collate as jcollate
from multimodal_context_reasoning_tpu.data import mixed as jmixed
from multimodal_context_reasoning_tpu.data import pmr as jpmr
from multimodal_context_reasoning_tpu.data import task_processors as jtp
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.data import vcr as jvcr
from multimodal_context_reasoning_tpu.models import fusion as jfusion
from multimodal_context_reasoning_tpu.models import oscar_heads as jheads
from multimodal_context_reasoning_tpu.models import rationale as jrationale
from multimodal_context_reasoning_torch.core.config import EncoderConfig as TEnc
from multimodal_context_reasoning_torch.data import collate as tcollate
from multimodal_context_reasoning_torch.data import pmr as tpmr
from multimodal_context_reasoning_torch.data import task_processors as ttp
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.data import vcr as tvcr
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.mixed import MixedDataset
from multimodal_context_reasoning_torch.interop.from_jax import oscar_heads_params_from_jax
from multimodal_context_reasoning_torch.models import oscar_heads as theads
from multimodal_context_reasoning_torch.models.fusion import ClsLayerLyx
from multimodal_context_reasoning_torch.models.rationale import ClsReasonLayer
from multimodal_context_reasoning_torch.serving.synthetic import (
    synthetic_features,
    task_rows,
    write_rows,
)

TOL = dict(rtol=2e-4, atol=2e-4)
ENC_KW = dict(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=32, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL, err_msg=what)


def _port_head(cls, params, *args, **kw):
    head = cls(TEnc(**ENC_KW), *args, **kw)
    head.load_state_dict(oscar_heads_params_from_jax(jax.tree.map(np.asarray, params)),
                         strict=True)
    return head.eval()


# ---------------------------------------------------------------- heads

@pytest.mark.parametrize("num_labels", [3, 1], ids=["ce", "mse"])
def test_sequence_classification_head(num_labels):
    rng = np.random.default_rng(0)
    pooled = rng.normal(size=(4, 16)).astype(np.float32)
    labels = (np.asarray([0, 1, 2, 1]) if num_labels > 1
              else rng.normal(size=(4,)).astype(np.float32))
    jhead = jheads.SequenceClassificationHead(JEnc(**ENC_KW), num_labels=num_labels)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(pooled), jnp.asarray(labels))
    want_loss, want = jhead.apply(params, jnp.asarray(pooled), jnp.asarray(labels))
    head = _port_head(theads.SequenceClassificationHead, params, num_labels)
    loss, logits = head(_t(pooled), _t(labels))
    assert logits.shape == (4, num_labels)
    _close(logits, want, "logits")
    _close(loss, want_loss, "loss")
    assert head(_t(pooled))[0] is None


def test_multiple_choice_head():
    pooled = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    labels = np.asarray([0, 3])
    jhead = jheads.MultipleChoiceHead(JEnc(**ENC_KW), num_choices=4)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(pooled), jnp.asarray(labels))
    want_loss, want = jhead.apply(params, jnp.asarray(pooled), jnp.asarray(labels))
    loss, logits = _port_head(theads.MultipleChoiceHead, params, 4)(_t(pooled), _t(labels))
    assert logits.shape == (2, 4)
    _close(logits, want, "logits")
    _close(loss, want_loss, "loss")


@pytest.mark.parametrize("smoothing,drop", [(0.1, 0.5), (0.1, 0.0), (0.0, 0.25)])
def test_captioning_loss(smoothing, drop):
    logits = np.random.default_rng(2).normal(size=(8, 64)).astype(np.float32)
    targets = np.random.default_rng(3).integers(0, 64, 8)
    want = jheads.CaptioningLoss(label_smoothing=smoothing, drop_worst_ratio=drop)(
        jnp.asarray(logits), jnp.asarray(targets))
    got = theads.CaptioningLoss(label_smoothing=smoothing, drop_worst_ratio=drop)(
        _t(logits), _t(targets))
    _close(got, want)
    if drop:   # drop-worst keeps the smallest losses
        full = theads.CaptioningLoss(label_smoothing=smoothing)(_t(logits), _t(targets))
        assert float(got) < float(full)


def test_pretraining_heads_in_fp32_over_bf16_inputs():
    """MLM (tied decoder + ``decoder_bias``) and image-text matching; the
    heads compute in fp32 even over a bf16 encoder's outputs, as the JAX
    heads (their Dense and LayerNorm take no dtype)."""
    rng = np.random.default_rng(4)
    seq = rng.normal(size=(2, 6, 16)).astype(np.float32)
    pooled = rng.normal(size=(2, 16)).astype(np.float32)
    wemb = rng.normal(size=(64, 16)).astype(np.float32)
    mlm = np.asarray([[-100, 3, -100, 7, -100, -100], [-100] * 6])
    itm = np.asarray([1, 0])
    jh = jheads.PretrainingHeads(JEnc(**ENC_KW))
    args = [jnp.asarray(a) for a in (seq, pooled, wemb, mlm, itm)]
    params = jh.init(jax.random.PRNGKey(0), *args)
    params = jax.tree.map(lambda p: p + 0.01 * jnp.arange(p.size).reshape(p.shape) / p.size,
                          params)   # a non-zero decoder_bias
    want = jh.apply(params, *args)
    head = _port_head(theads.PretrainingHeads, params, 64)
    assert set(head.state_dict()) == {
        "predictions.transform.weight", "predictions.transform.bias",
        "predictions.transform_layer_norm.weight", "predictions.transform_layer_norm.bias",
        "predictions.decoder_bias", "seq_relationship.weight", "seq_relationship.bias"}
    got = head(_t(seq), _t(pooled), _t(wemb), _t(mlm), _t(itm))
    for name in ("loss", "mlm_logits", "itm_logits"):
        _close(getattr(got, name), getattr(want, name), name)
    half = head(_t(seq).bfloat16(), _t(pooled).bfloat16(), _t(wemb).bfloat16(), _t(mlm),
                _t(itm))
    assert half.mlm_logits.dtype == half.itm_logits.dtype == torch.float32
    want16 = jh.apply(params, *[a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a
                                for a in args])
    assert want16.mlm_logits.dtype == jnp.float32
    _close(half.mlm_logits, want16.mlm_logits, "bf16 inputs")
    assert head(_t(seq), _t(pooled), _t(wemb)).loss is None


# ---------------------------------------------------------------- processors

def _both(name, *args):
    return (getattr(jtp, name)().get_train_examples(*args),
            getattr(ttp, name)().get_train_examples(*args))


def _same(j_examples, t_examples):
    assert [dataclasses.asdict(e) for e in t_examples] == [
        dataclasses.asdict(e) for e in j_examples]
    return t_examples


def test_vqa_and_gqa_processors(tmp_path):
    rows = [{"q_id": 1, "q": "what color?", "img_id": "7", "label": ["red"], "score": [1.0]},
            {"question": "how many?", "image_id": 9, "label": ["2", "3"], "score": [0.6, 0.3]}]
    (tmp_path / "train.json").write_text("\n".join(json.dumps(r) for r in rows))
    ex = _same(*_both("VQAProcessor", str(tmp_path)))
    assert ex[0].text_a == "what color?" and ex[0].img_key == "7"
    assert ex[1].guid == "train-1" and ex[1].score == [0.6, 0.3]
    (tmp_path / "train.json").write_text(json.dumps(rows))   # the json-array form
    _same(*_both("GQAProcessor", str(tmp_path)))
    assert ttp.GQAProcessor().get_labels() is None


def test_ans2label_json_and_pickle(tmp_path):
    d = {"net": 0, "yes": 3, "no": 1}
    (tmp_path / "a2l.json").write_text(json.dumps(d))
    (tmp_path / "a2l.pkl").write_bytes(pickle.dumps(d))
    for name in ("a2l.json", "a2l.pkl"):
        path = str(tmp_path / name)
        assert ttp.load_ans2label(path) == jtp.load_ans2label(path) == d
        assert ttp.VQAProcessor().get_labels(path) == jtp.VQAProcessor().get_labels(path)


def test_nlvr_and_vcr_processors(tmp_path):
    (tmp_path / "val.json").write_text(json.dumps(
        [{"identifier": "a", "sent": "two dogs", "label": "True"},
         {"identifier": "b", "sentence": "no cat", "label": "False"}]))
    ex = _same(jtp.NLVRProcessor().get_dev_examples(str(tmp_path)),
               ttp.NLVRProcessor().get_dev_examples(str(tmp_path)))
    assert [e.label for e in ex] == [1, 0]
    rows = [{"annot_id": "x", "question": ["why", "?"], "img_id": "i",
             "answer_choices": [["a"], ["b"], ["c"], ["d"]], "answer_label": 2,
             "rationale_choices": [["r1"], ["r2"], ["r3"], ["r4"]], "rationale_label": 1}]
    (tmp_path / "train.json").write_text(json.dumps(rows))
    qa = _same(*_both("VCRProcessor", str(tmp_path)))
    assert [e.label for e in qa] == [0, 0, 1, 0]
    qar = _same(jtp.PROCESSORS["vcr_qa_r"]().get_train_examples(str(tmp_path)),
                ttp.PROCESSORS["vcr_qa_r"]().get_train_examples(str(tmp_path)))
    assert qar[0].text_a.endswith("c") and [e.label for e in qar] == [0, 1, 0, 0]
    assert (ttp.PROCESSORS.keys() == jtp.PROCESSORS.keys()
            and ttp.OUTPUT_MODES == jtp.OUTPUT_MODES
            and ttp.TASK_NUM_LABELS == jtp.TASK_NUM_LABELS)


# ---------------------------------------------------------------- mixtures

@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """PMR and VCR datasets of both packages over rows and features written
    from a seed (the JAX tests read the reference data, absent here)."""
    d = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(5)
    pmr_path, vcr_path = str(d / "pmr.jsonl"), str(d / "vcr.json")
    write_rows(pmr_path, task_rows(rng, 6, 8, words=(1, 4)))
    write_rows(vcr_path, task_rows(rng, 5, 8, vcr=True, first=100, words=(1, 4)))
    cfg = JConfig.tiny()
    out = {}
    for side, tok, coll, pmr, vcr in (("jax", jtok, jcollate, jpmr, jvcr),
                                      ("port", ttok, tcollate, tpmr, tvcr)):
        pmr_ex, vcr_ex = pmr.load_pmr_jsonl(pmr_path), vcr.load_vcr_json(vcr_path)
        spec = coll.BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len,
                              roberta_len=cfg.roberta_len, num_labels=cfg.num_labels,
                              img_feature_dim=cfg.seq_encoder.img_feature_dim)
        feats = synthetic_features({e.img_id for e in pmr_ex + vcr_ex},
                                   cfg.seq_encoder.img_feature_dim, max_regions=cfg.img_len)
        kw = dict(spec=spec, max_chunks=cfg.max_chunks)
        bert = tok.HashTokenizer(vocab_size=cfg.seq_encoder.vocab_size)
        rob = tok.RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size)
        if side == "jax":
            from multimodal_context_reasoning_tpu.data.schemas import ImageFeatures
            feats = {k: ImageFeatures(features=v.features, num_regions=v.num_regions)
                     for k, v in feats.items()}
        out[side] = (pmr.PMRDataset(pmr_ex, feats, bert, rob, **kw),
                     vcr.VCRDataset(vcr_ex, feats, bert, rob, **kw))
    return out


def test_synthetic_features_equal_the_jax_scripts():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from scripts.train_real_pmr import synthetic_features as jfeatures

    ids = {"img-1", "img-22", "7"}
    want, got = jfeatures(ids, 20, max_regions=12), synthetic_features(ids, 20, max_regions=12)
    assert set(got) == set(want)
    for k in want:
        assert got[k].num_regions == want[k].num_regions
        np.testing.assert_array_equal(got[k].features, want[k].features)


def test_mixed_batches_match_the_owner_and_jax(children):
    pmr, vcr = children["port"]
    mixed = MixedDataset([pmr, vcr])
    jmix = jmixed.MixedDataset(list(children["jax"]))
    assert len(mixed) == len(jmix) == len(pmr) + len(vcr)
    off, K = len(pmr), pmr.spec.num_labels
    for idx in ([0, 2], [off + 1, off + 3], [1, off], list(range(len(mixed)))):
        got, want = mixed.batch(idx), jmix.batch(idx)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{idx} {key}")
    for key, val in vcr.batch([1, 3]).items():
        np.testing.assert_array_equal(mixed.batch([off + 1, off + 3])[key], val, err_msg=key)
    straddle = mixed.batch([1, off])   # example-major across the children
    np.testing.assert_array_equal(straddle["input_ids"][:K], pmr.batch([1])["input_ids"])
    np.testing.assert_array_equal(straddle["input_ids"][K:], vcr.batch([0])["input_ids"])


def test_mixed_loader_epoch_covers_both_tasks(children):
    mixed = MixedDataset(list(children["port"]))
    n = sum(float(b["example_mask"].sum()) for b in DataLoader(mixed, 4, shuffle=True, seed=0))
    assert n == len(mixed)


def test_mixed_refuses_disagreeing_specs_and_no_children(children):
    pmr, vcr = children["port"]
    other = dataclasses.replace(pmr.spec, text_len=pmr.spec.text_len + 8)
    bad = tpmr.PMRDataset(pmr.examples, pmr.image_features, pmr.bert, pmr.roberta, spec=other,
                          max_chunks=pmr.max_chunks)
    with pytest.raises(ValueError, match="BatchSpec"):
        MixedDataset([bad, vcr])
    with pytest.raises(ValueError, match="at least one"):
        MixedDataset([])


# ---------------------------------------------------------------- layer options

@pytest.mark.parametrize("tau,neg", [(1.0, False), (0.5, False), (2.0, True)])
def test_cls_reason_layer_options_match_jax(tau, neg):
    rng = np.random.default_rng(6)
    memory = rng.normal(size=(3, 7, 16)).astype(np.float32)
    cls = rng.normal(size=(3, 16)).astype(np.float32)
    bias = np.where(rng.random((3, 1, 1, 7)) < 0.3, -1e4, 0.0).astype(np.float32)
    jlayer = jrationale.ClsReasonLayer(JEnc(**ENC_KW))
    args = [jnp.asarray(a) for a in (memory, cls, bias)]
    params = jlayer.init(jax.random.PRNGKey(0), *args)
    want_h, want_p = jlayer.apply(params, *args, tau=tau, neg=neg)
    layer = ClsReasonLayer(TEnc(**ENC_KW)).eval()
    p = jax.tree.map(np.asarray, params)["params"]
    sd = {}
    for name in ("cls_q_proj", "align_k_proj", "dense"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(p[name]["kernel"].T), _t(p[name]["bias"])
    for key, node in (("LayerNorm", p["layer_norm"]),
                      ("output.LayerNorm", p["ffn"]["output_layer_norm"])):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(node["scale"]), _t(node["bias"])
    for key, node in (("intermediate.dense", p["ffn"]["intermediate"]),
                      ("output.dense", p["ffn"]["output"])):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(node["kernel"].T), _t(node["bias"])
    layer.load_state_dict(sd, strict=True)
    with torch.no_grad():
        h, probs = layer(*map(_t, (memory, cls, bias)), tau=tau, neg=neg)
        h1, p1 = layer(*map(_t, (memory, cls, bias)))
    _close(h, want_h, "hidden")
    _close(probs, want_p, "probs")
    if (tau, neg) == (1.0, False):   # the production call, bit for bit
        assert torch.equal(h, h1) and torch.equal(probs, p1)


@pytest.mark.parametrize("tau,neg_type,prior", [(1.0, False, False), (0.5, False, False),
                                                (1.0, True, False), (2.0, True, True),
                                                (1.0, False, True)])
def test_cls_layer_lyx_options_match_jax(tau, neg_type, prior):
    rng = np.random.default_rng(7)
    memory = rng.normal(size=(3, 7, 16)).astype(np.float32)
    cls = rng.normal(size=(3, 16)).astype(np.float32)
    bias = np.where(rng.random((3, 1, 1, 7)) < 0.3, -1e4, 0.0).astype(np.float32)
    prior_score = rng.random((3, 1, 7)).astype(np.float32) if prior else None
    jlayer = jfusion.ClsLayerLyx(JEnc(**ENC_KW), num_heads=2, tau=tau, neg_type=neg_type)
    args = [jnp.asarray(a) for a in (memory, cls, bias)]
    jprior = None if prior_score is None else jnp.asarray(prior_score)
    params = jlayer.init(jax.random.PRNGKey(0), *args, jprior)
    want = jlayer.apply(params, *args, jprior)
    p = jax.tree.map(np.asarray, params)["params"]
    sd = {}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd[f"cross_attention.{proj}.weight"] = _t(p[proj]["kernel"].T)
        sd[f"cross_attention.{proj}.bias"] = _t(p[proj]["bias"])
    for key, node in (("LayerNorm", p["layer_norm"]),
                      ("output.LayerNorm", p["ffn"]["output_layer_norm"])):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(node["scale"]), _t(node["bias"])
    for key, node in (("intermediate.dense", p["ffn"]["intermediate"]),
                      ("output.dense", p["ffn"]["output"])):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(node["kernel"].T), _t(node["bias"])
    layer = ClsLayerLyx(TEnc(**ENC_KW), num_heads=2, tau=tau, neg_type=neg_type).eval()
    layer.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = layer(*map(_t, (memory, cls, bias)),
                    None if prior_score is None else _t(prior_score))
    _close(got, want)


def test_cls_layer_lyx_options_keep_dropout_in_training():
    """The explicit path drops attention probabilities in training and
    nowhere else (statistically: the JAX and torch masks differ)."""
    enc = dataclasses.replace(TEnc(**ENC_KW), attention_probs_dropout_prob=0.5)
    layer = ClsLayerLyx(enc, num_heads=2, tau=0.5)
    memory, cls = torch.randn(64, 7, 16), torch.randn(64, 16)
    with torch.no_grad():
        a, b = layer.eval()(memory, cls, None), layer.eval()(memory, cls, None)
        c = layer.train()(memory, cls, None)
    assert torch.equal(a, b) and not torch.allclose(a, c)
