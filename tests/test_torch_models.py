"""PyTorch port, model layer: every module of the scoring path held against
the JAX package at ``ModCRConfig.tiny()``, with the JAX weights carried
across by ``params_from_jax`` and the same numpy batch on both sides
(fp32, atol = rtol = 2e-4, the bound tests/test_pallas.py uses)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.interop.export import export_modcr_state_dict
from multimodal_context_reasoning_tpu.models import encoders as jenc
from multimodal_context_reasoning_tpu.models import fusion as jfusion
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.models.roberta import (
    PrefixRoberta as JRoberta,
    stack_layer_params,
)
from multimodal_context_reasoning_tpu.ops.chunk import chunk_mask_from_gather_index
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.layers import ACT
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel

TOL = dict(rtol=2e-4, atol=2e-4)


def make_batch(cfg, n_examples=2, seed=0):
    """A collate-shaped batch: ragged text, regions and RoBERTa streams,
    real chunk ids, K identical image rows per example."""
    rng = np.random.default_rng(seed)
    K = cfg.num_labels
    N, T, I, R = n_examples * K, cfg.text_len, cfg.img_len, cfg.roberta_len
    F = cfg.global_encoder.img_feature_dim
    vocab = cfg.global_encoder.vocab_size
    text_mask = np.zeros((N, T), np.float32)
    gather = np.full((N, T), -1, np.int32)
    for n in range(N):
        length = int(rng.integers(6, T + 1))
        text_mask[n, :length] = 1.0
        for t in range(1, length - 1):
            gather[n, t] = (t - 1) // 3
    img_mask = np.zeros((N, I), np.float32)
    feat = np.zeros((N, I, F), np.float32)
    for e in range(n_examples):
        n_reg = int(rng.integers(min(2, I), I + 1))   # one region where I = 1
        img_mask[e * K:(e + 1) * K, :n_reg] = 1.0
        feat[e * K:(e + 1) * K, :n_reg] = rng.normal(size=(n_reg, F))
    r_mask = np.zeros((N, R), np.float32)
    for n in range(N):
        r_mask[n, :int(rng.integers(5, R + 1))] = 1.0
    label = np.zeros((N,), np.float32)
    label[::K] = 1.0
    token_type = np.zeros((N, T), np.int32)
    token_type[:, T // 2:] = 1
    input_ids = (rng.integers(3, vocab, (N, T)) * text_mask).astype(np.int32)
    input_ids[:, 0] = 1  # [CLS]: the K rows of an example share [CLS] + image
    return dict(
        input_ids=input_ids,
        token_type_ids=token_type,
        text_mask=text_mask,
        gather_index=gather,
        total_label=rng.integers(0, I, (N, T)).astype(np.int32),
        align_pos=(rng.random((N, T)) < 0.3).astype(np.int32),
        r_input_ids=np.where(r_mask > 0, rng.integers(3, vocab, (N, R)), 1).astype(np.int32),
        r_token_type_ids=np.zeros((N, R), np.int32),
        r_attention_mask=r_mask,
        img_feat=feat,
        img_mask=img_mask,
        label=label,
    )


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny():
    """JAX tiny model, its params, the port carrying them, one batch."""
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    batch = make_batch(jcfg)
    jmodel = JModel(jcfg)
    params = jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), _j(batch)))
    sd = params_from_jax(params, tcfg)
    tmodel = TModel(tcfg, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tmodel.eval()
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, params=params, sd=sd,
                tmodel=tmodel, root=params["params"])


def test_params_from_jax_equals_export(tiny):
    """Same keys and values as the JAX package's reference-layout export,
    plus the edge_dense key the port's strict load needs."""
    want = export_modcr_state_dict(tiny["params"], tiny["jcfg"])
    got = tiny["sd"]
    assert set(got) == set(want)
    assert "calec.seq_enc.edge_dense.weight" in got
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert set(TModel(tiny["tcfg"], device="cpu").state_dict()) == set(got)


def test_params_from_jax_unstacks_scanned_roberta(tiny):
    root = dict(tiny["root"])
    n = tiny["jcfg"].roberta.num_hidden_layers
    root["roberta"] = stack_layer_params(root["roberta"], n)
    assert "layers" in root["roberta"]
    got = params_from_jax({"params": root}, tiny["tcfg"])
    assert set(got) == set(tiny["sd"])
    for key, t in tiny["sd"].items():
        assert torch.equal(got[key], t), key


def test_global_encoder_matches(tiny):
    b = tiny["batch"]
    mask = np.concatenate([b["text_mask"], b["img_mask"]], axis=-1)
    want = jenc.GlobalImageEncoder(tiny["jcfg"].global_encoder).apply(
        {"params": tiny["root"]["global_enc"]}, b["input_ids"], b["img_feat"], mask,
        b["token_type_ids"])
    with torch.no_grad():
        tb = _t(dict(b, mask=mask))
        got = tiny["tmodel"].calec.global_enc(
            tb["input_ids"], tb["img_feat"], tb["mask"], tb["token_type_ids"])
    np.testing.assert_allclose(got.sequence.numpy(), np.asarray(want.sequence), **TOL)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(want.pooled), **TOL)


@pytest.fixture(scope="module")
def chunkalign(tiny):
    cfg, b = tiny["jcfg"], tiny["batch"]
    cm = np.asarray(chunk_mask_from_gather_index(
        jnp.asarray(b["gather_index"]), jnp.asarray(b["text_mask"])))
    want = jenc.ChunkAlignEncoder(cfg.seq_encoder, cfg.chunkalign).apply(
        {"params": tiny["root"]["seq_enc"]}, b["input_ids"], b["img_feat"],
        b["text_mask"], b["img_mask"], cm, b["gather_index"], cfg.max_chunks,
        b["token_type_ids"], output_attentions=True)
    tb = _t(b)
    with torch.no_grad():
        got = tiny["tmodel"].calec.seq_enc(
            tb["input_ids"], tb["img_feat"], tb["text_mask"], tb["img_mask"],
            _np(cm), tb["gather_index"], cfg.max_chunks,
            tb["token_type_ids"], output_attentions=True)
    return want, got


@pytest.mark.parametrize("field", ["sequence", "pooled", "chunk_hidden", "attn_probs"])
def test_chunkalign_encoder_matches(chunkalign, field):
    want, got = chunkalign
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(want, field)), **TOL)


def test_chunkalign_encoder_without_probs_runs_spec_path(tiny, chunkalign):
    """output_attentions=False: every layer takes the stage-mask attention
    and no dense [L, L] bias is built; the outputs stay the same."""
    cfg, b = tiny["jcfg"], tiny["batch"]
    want, _ = chunkalign
    tb = _t(b)
    with torch.no_grad():
        got = tiny["tmodel"].calec.seq_enc(
            tb["input_ids"], tb["img_feat"], tb["text_mask"], tb["img_mask"], None,
            tb["gather_index"], cfg.max_chunks, tb["token_type_ids"],
            output_attentions=False)
    assert got.attn_probs is None
    np.testing.assert_allclose(got.sequence.numpy(), np.asarray(want.sequence), **TOL)


def test_fusion_matches(tiny, chunkalign):
    cfg, b = tiny["jcfg"], tiny["batch"]
    s_want, _ = chunkalign
    rng = np.random.default_rng(5)
    N, L, D = s_want.sequence.shape
    g_seq = rng.normal(size=(N, L, D)).astype(np.float32)
    g_cls = rng.normal(size=(N, D)).astype(np.float32)
    views = [np.asarray(x) for x in (s_want.sequence, s_want.pooled,
                                     s_want.chunk_hidden, s_want.attn_probs)]
    want = jfusion.ChunkAlignFusion(cfg.global_encoder, cfg.chunkalign).apply(
        {"params": tiny["root"]["fusion"]}, g_seq, g_cls, *views, b["text_mask"],
        cfg.text_len, b["align_pos"], b["total_label"])
    with torch.no_grad():
        got = tiny["tmodel"].calec(
            *(_np(x) for x in (g_seq, g_cls, *views)), _np(b["text_mask"]),
            cfg.text_len, _np(b["align_pos"]), _np(b["total_label"]))
    for field in ("cls_ensem", "align_loss", "align_logits"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **TOL)


def test_prefix_roberta_matches(tiny):
    cfg, b = tiny["jcfg"], tiny["batch"]
    rng = np.random.default_rng(7)
    N = b["r_input_ids"].shape[0]
    prefix = rng.normal(size=(N, cfg.total_prefix_len, cfg.roberta.hidden_size)
                        ).astype(np.float32)
    pmask = np.ones((N, cfg.total_prefix_len), np.float32)
    pmask[1, 3:5] = 0.0   # masked prefix slots ride the same mask vector
    want = JRoberta(cfg.roberta).apply(
        {"params": tiny["root"]["roberta"]}, b["r_input_ids"], b["r_attention_mask"],
        b["r_token_type_ids"], prefix, pmask)
    tb = _t(dict(b, prefix=prefix, pmask=pmask))
    with torch.no_grad():
        got = tiny["tmodel"].roberta(tb["r_input_ids"], tb["r_attention_mask"],
                                     tb["r_token_type_ids"], tb["prefix"], tb["pmask"])
    np.testing.assert_allclose(got.sequence.numpy(), np.asarray(want.sequence), **TOL)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(want.pooled), **TOL)


@pytest.mark.parametrize("compute_alignment", [True, False])
def test_modcr_matches(tiny, compute_alignment):
    jcfg = dataclasses.replace(tiny["jcfg"], compute_alignment=compute_alignment)
    tcfg = dataclasses.replace(tiny["tcfg"], compute_alignment=compute_alignment)
    want = JModel(jcfg).apply(tiny["params"], _j(tiny["batch"]))
    tmodel = TModel(tcfg, device="cpu")
    tmodel.load_state_dict(tiny["sd"], strict=True)
    with torch.no_grad():
        got = tmodel.eval()(_t(tiny["batch"]))
    for field in ("logits", "loss", "align_loss", "abstract_loss"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **TOL,
                                   err_msg=field)
    if not compute_alignment:
        assert float(got.align_loss) == 0.0


def test_dedup_vision_prefix_is_exact(tiny):
    """The vision pass run once per example gives the per-row logits."""
    tcfg = dataclasses.replace(tiny["tcfg"], dedup_vision_prefix=False)
    tmodel = TModel(tcfg, device="cpu")
    tmodel.load_state_dict(tiny["sd"], strict=True)
    with torch.no_grad():
        per_row = tmodel.eval()(_t(tiny["batch"])).logits
        dedup = tiny["tmodel"](_t(tiny["batch"])).logits
    torch.testing.assert_close(dedup, per_row, rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", [
    dict(use_seq_encoder=False), dict(prefix_mode="promptfuse")])
def test_ablations_match(tiny, variant):
    jcfg = dataclasses.replace(tiny["jcfg"], **variant)
    tcfg = dataclasses.replace(tiny["tcfg"], **variant)
    batch = tiny["batch"]
    jmodel = JModel(jcfg)
    params = jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(1), _j(batch)))
    tmodel = TModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    want = jmodel.apply(params, _j(batch))
    with torch.no_grad():
        got = tmodel.eval()(_t(batch))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **TOL)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), **TOL)


def test_config_json_round_trips_both_ways():
    for cfg in (JConfig(), JConfig.tiny().with_dtype("bfloat16")):
        assert TConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
        assert JConfig.from_json(TConfig.from_json(cfg.to_json()).to_json()) == cfg
    assert TConfig().with_dtype("bfloat16").roberta.torch_dtype == torch.bfloat16


def test_gelu_is_flax_tanh_form():
    x = torch.tensor([1.0, -0.5, 2.0])
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ACT["gelu"](x).numpy(), want, rtol=1e-6, atol=1e-7)
    assert abs(float(ACT["gelu"](torch.tensor(1.0))) - 0.841192) < 1e-6


def test_init_is_seeded_and_follows_jax_distributions():
    cfg = TConfig.tiny()
    a = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    b = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    emb = a["roberta.embeddings.word_embeddings.weight"]
    assert abs(float(emb.std()) - cfg.roberta.initializer_range) < 2e-3
    w = a["roberta.encoder.layer.0.intermediate.dense.weight"]   # [out, in]
    assert abs(float(w.std()) - (1.0 / w.shape[1]) ** 0.5) < 0.1 * (1.0 / w.shape[1]) ** 0.5
    assert torch.equal(a["roberta.encoder.layer.0.output.LayerNorm.weight"],
                       torch.ones(cfg.roberta.hidden_size))
    assert not a["roberta.encoder.layer.0.attention.self.query.bias"].any()
