"""PyTorch port: ModCR with the LFM2 mixture-of-experts reasoner
(``models/lfm2.py``, ``ModCRConfig.reasoner == "lfm2_moe"``).

On the CPU, fp32, at a tiny LFM2 (hidden 64, 4 query and 2 KV heads, six
layers conv, conv, attention, conv, conv, attention, two dense and four
MoE, 8 experts top-2) on the tiny towers, with the benchmark's seeded
weights (``modcr_bench/lfm2_params.py``: norms off 1, a non-zero expert
bias): the logits against the plain reference ``modcr_bench/reference/
lfm2.py``; the all-dense reasoner against transformers' ``Lfm2Model``;
the grouped route against the per-expert loop; the expert bias; right
padding; one train step; the config's JSON.

Marked ``cuda``, on the card and skipped without one (the file imports
neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_lfm2.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from multimodal_context_reasoning_torch.core.config import Lfm2MoeConfig, ModCRConfig, TrainConfig
from multimodal_context_reasoning_torch.models import lfm2
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer, cast_to_compute_dtypes
from multimodal_context_reasoning_torch.serving.synthetic import (
    hash_tokenizers,
    synthetic_dataset,
    synthetic_examples,
)
from multimodal_context_reasoning_torch.train import step
from multimodal_context_reasoning_torch.train.graphs import SegmentedGraphs
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.trainer import Trainer
from multimodal_context_reasoning_torch.utils import profiling

from modcr_bench import lfm2_params
from modcr_bench.metrics._moe import EXPERT_KERNELS
from modcr_bench.reference import lfm2 as reference

PATTERN = ("conv", "conv", "full_attention", "conv", "conv", "full_attention")
TINY = Lfm2MoeConfig(vocab_size=256, hidden_size=64, intermediate_size=96,
                     moe_intermediate_size=32, num_hidden_layers=6, num_attention_heads=4,
                     num_key_value_heads=2, num_dense_layers=2, num_experts=8,
                     num_experts_per_tok=2, layer_types=PATTERN)


def modcr_config(lf: Lfm2MoeConfig = TINY) -> ModCRConfig:
    # text 32 and 40 reasoner tokens: the four candidates of a question differ
    return dataclasses.replace(ModCRConfig.tiny(), reasoner="lfm2_moe", lfm2=lf,
                               text_len=32, roberta_len=40)


def seeded(cfg: ModCRConfig, seed: int = 5, device="cpu"):
    """(model, weights): the model holds the benchmark's seeded weights."""
    P = lfm2_params.make(json.loads(cfg.to_json()), seed, device)
    model = ModCRModel(cfg, device="meta")
    model.load_state_dict(P, strict=True, assign=True)
    return model.eval(), P


def batch_of(cfg: ModCRConfig, questions=(0, 1, 2), device="cpu"):
    ds = synthetic_dataset(np.random.default_rng(0), 8, cfg)
    return {k: torch.from_numpy(v).to(device) for k, v in ds.batch(list(questions)).items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the CPU

def test_logits_match_the_plain_reference():
    cfg = modcr_config()
    model, P = seeded(cfg)
    b = batch_of(cfg)
    with torch.no_grad():
        got = model(b).logits
    want = reference.forward(P, json.loads(cfg.to_json()), b)
    assert got.shape == (3, 4)
    assert (got - got.mean(1, keepdim=True)).abs().max() > 1e-3     # candidates differ
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_dense_reasoner_matches_transformers():
    """Every layer dense, the reasoner against transformers' ``Lfm2Model``
    (eager attention, ``block_auto_adjust_ff_dim=False``) on the same
    weights: the convolution, RoPE, the QK norms and GQA."""
    from transformers.models.lfm2.configuration_lfm2 import Lfm2Config
    from transformers.models.lfm2.modeling_lfm2 import Lfm2Model

    lf = dataclasses.replace(TINY, num_dense_layers=TINY.num_hidden_layers)
    ours = lfm2.Lfm2Reasoner(lf)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in ours.named_parameters():
            scale = 0.05 if name.endswith("norm.weight") else p.shape[-1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=gen) * scale
                    + (1.0 if name.endswith("norm.weight") else 0.0))
    hf = Lfm2Model(Lfm2Config(
        vocab_size=lf.vocab_size, hidden_size=lf.hidden_size, intermediate_size=lf.intermediate_size,
        num_hidden_layers=lf.num_hidden_layers, num_attention_heads=lf.num_attention_heads,
        num_key_value_heads=lf.num_key_value_heads, norm_eps=lf.norm_eps,
        rope_theta=lf.rope_theta, conv_L_cache=lf.conv_L_cache, conv_bias=False,
        block_auto_adjust_ff_dim=False, layer_types=list(lf.layer_types),
        max_position_embeddings=64, attn_implementation="eager")).eval()
    missing, unexpected = hf.load_state_dict(ours.state_dict(), strict=False)
    assert not unexpected and all("inv_freq" in k for k in missing)
    ids = torch.randint(4, lf.vocab_size, (3, 12), generator=gen)
    mask = torch.ones(3, 12)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    prefix = torch.randn(3, 5, lf.hidden_size, generator=gen)
    with torch.no_grad():
        got = ours.embedding_norm(ours.hidden_states(ids, mask, prefix))
        embeds = torch.cat([prefix, hf.embed_tokens(ids)], dim=1)
        valid = torch.cat([torch.ones(3, 5), mask], dim=1)
        want = hf(inputs_embeds=embeds, attention_mask=valid.long()).last_hidden_state
    keep = valid.bool()
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=1e-5)
    torch.testing.assert_close(ours(ids, mask, prefix),
                               got[torch.arange(3), 5 + mask.sum(1).long() - 1])


def tiny_moe(seed=0):
    moe = lfm2.SparseMoe(TINY, 0)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[-1] ** -0.5)
        moe.expert_bias.copy_(torch.randn(TINY.num_experts, generator=gen) * 0.05)
    x = torch.randn(40, TINY.hidden_size, generator=gen)
    return moe, x


def test_grouped_route_matches_the_loop():
    moe, x = tiny_moe()
    with torch.no_grad():
        moe.expert_bias[0] = -10.0          # expert 0 gets no token: an empty group
        sel, w, counts = moe.route(x)
        assert counts[0] == 0 and counts.sum() == x.shape[0] * TINY.num_experts_per_tok
        want = lfm2.looped_experts(x, sel, w, moe.experts)
        got = lfm2.grouped_experts(x, sel, w, counts, *moe.stacked_weights(torch.float32))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_expert_bias_selects_and_does_not_weigh():
    moe, x = tiny_moe(1)
    with torch.no_grad():
        sel_b, w_b, _ = moe.route(x)
        s = torch.sigmoid(moe.gate(x))
        saved = moe.expert_bias.clone()
        moe.expert_bias.zero_()
        sel_0, w_0, _ = moe.route(x)
        moe.expert_bias.copy_(saved)
    same = (sel_b.sort(-1).values == sel_0.sort(-1).values).all(-1)
    assert 0 < int(same.sum()) < x.shape[0]          # it changes some selections
    want = s.gather(-1, sel_b)
    torch.testing.assert_close(w_b, want / (want.sum(-1, keepdim=True) + lfm2.ROUTE_EPS))
    torch.testing.assert_close(w_b[same].sort(-1).values, w_0[same].sort(-1).values)


def test_extra_right_padding_leaves_the_logits():
    cfg = modcr_config()
    model, _ = seeded(cfg)
    b = batch_of(cfg)
    wide = dict(b)
    wide["r_input_ids"] = torch.cat([b["r_input_ids"],
                                     torch.ones(b["r_input_ids"].shape[0], 9, dtype=torch.long)], 1)
    wide["r_attention_mask"] = torch.cat([b["r_attention_mask"],
                                          torch.zeros(b["r_attention_mask"].shape[0], 9)], 1)
    with torch.no_grad():
        torch.testing.assert_close(model(wide).logits, model(b).logits, rtol=0, atol=1e-5)


def test_one_train_step_has_finite_gradients():
    cfg = modcr_config()
    model = ModCRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, TrainConfig(learning_rate=1e-3), total_steps=4)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step.train_step(state, batch_of(cfg))
    assert torch.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    for name in ("reasoner.layers.0.conv.conv.weight", "reasoner.layers.2.self_attn.q_proj.weight",
                 "reasoner.layers.3.feed_forward.gate.weight", "mapping_network_alignment.4.weight"):
        assert name in moved, name
    assert any(".feed_forward.experts." in n for n in moved)
    assert not any(n.startswith(("calec.global_enc.", "calec.seq_enc.")) for n in moved)


def test_spans_counters_and_the_expert_tally():
    cfg = modcr_config()
    model, _ = seeded(cfg)
    b = batch_of(cfg)
    names = ("reasoner.conv.layers", "reasoner.attention.layers", "moe.layers")
    start = [profiling.counter(n) for n in names]
    was = profiling.enable_spans(True)
    try:
        profiling.read_tally(lfm2.EXPERT_TALLY)
        step.eval_step(model, b)               # under inference mode
        tally = profiling.read_tally(lfm2.EXPERT_TALLY)
        spans = profiling.span_table()["spans"]
    finally:
        profiling.enable_spans(was)
    assert [profiling.counter(n) - s for n, s in zip(names, start)] == [4, 2, 4]
    tokens = b["r_input_ids"].shape[0] * (cfg.total_prefix_len + cfg.roberta_len)
    assert tally.shape == (4, 8) and tally.sum(1).tolist() == [2 * tokens] * 4
    for name in ("model.reasoner", "reasoner.conv", "reasoner.attention", "reasoner.moe.route",
                 "reasoner.moe.experts"):
        assert name in spans, name


def test_trainer_evaluate_and_the_scorer_run_it():
    """The entry points take the LFM2 reasoner as they are: ``Trainer.evaluate``
    over the program's loader, and ``ModCRScorer`` from a state dict (its cast
    keeps the routers fp32) giving the model's own logits."""
    cfg = modcr_config()
    model, P = seeded(cfg)
    ds = synthetic_dataset(np.random.default_rng(0), 8, cfg)
    loader = DataLoader(ds, 4)
    assert 0.0 <= Trainer(model, TrainConfig(), loader, loader, device="cpu").evaluate() <= 1.0
    feats, examples = synthetic_examples(np.random.default_rng(0), 3, cfg)
    scorer = ModCRScorer(cfg, P, *hash_tokenizers(cfg), feats, micro_batch=3, device="cpu")
    bf16, _ = seeded(cfg.with_dtype("bfloat16"))
    moe = cast_to_compute_dtypes(bf16).reasoner.layers[2].feed_forward
    assert moe.gate.weight.dtype == moe.expert_bias.dtype == torch.float32
    assert moe.experts[0].w1.weight.dtype == bf16.reasoner.embed_tokens.weight.dtype == torch.bfloat16
    got = torch.tensor([r["logits"] for r in scorer.score(examples)])
    with torch.no_grad():
        want = model(batch_of(cfg)).logits
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_config_json_round_trip_and_old_configs():
    cfg = modcr_config()
    assert ModCRConfig.from_json(cfg.to_json()) == cfg
    assert ModCRConfig.from_json(cfg.with_dtype("bfloat16").to_json()).lfm2.dtype == "bfloat16"
    old = ModCRConfig.tiny()
    raw = json.loads(old.to_json())
    assert "reasoner" not in raw and "lfm2" not in raw
    assert ModCRConfig.from_json(old.to_json()).reasoner == "roberta"
    with pytest.raises(ValueError, match="int8"):
        cfg.with_quantize("int8")
    with pytest.raises(ValueError):
        dataclasses.replace(ModCRConfig.tiny(), reasoner="lfm2_moe")
    with pytest.raises(ValueError):
        dataclasses.replace(TINY, layer_types=PATTERN[:5])


# ---------------------------------------------------------------- the card

# a mid-size LFM2: heads of 64 (the kernels' width), 16 experts of 256
MID = Lfm2MoeConfig(vocab_size=4096, hidden_size=512, intermediate_size=1024,
                    moe_intermediate_size=256, num_hidden_layers=6, num_attention_heads=8,
                    num_key_value_heads=2, num_dense_layers=2, num_experts=16,
                    num_experts_per_tok=4, layer_types=PATTERN, dtype="bfloat16")
QUESTIONS = 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped route and CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mid():
    dev = _card()
    cfg = dataclasses.replace(modcr_config(MID).with_dtype("bfloat16"), roberta_len=128)
    model, _ = seeded(cfg, 2147490023, dev)
    ds = synthetic_dataset(np.random.default_rng(11), 4 * QUESTIONS, cfg)

    def batch(i):
        host = ds.batch(list(range(QUESTIONS * i, QUESTIONS * (i + 1))))
        return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    return model, batch, cfg


@pytest.mark.cuda
def test_card_grouped_route_matches_the_loop_at_the_published_widths():
    """One MoE layer of LFM2-8B-A1B (D 2048, 32 experts of 1792, top 4) on
    a scoring batch's 17,664 tokens, bf16: the grouped products against
    the per-expert loop in the same dtype, and the loop in fp32."""
    dev = _card()
    c = dataclasses.replace(Lfm2MoeConfig(), dtype="bfloat16")
    moe = lfm2.SparseMoe(c, 0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * p.shape[-1] ** -0.5)
        moe.expert_bias.copy_(torch.randn(c.num_experts, generator=gen, device=dev) * 0.05)
        x = torch.randn(128, 138, c.hidden_size, generator=gen, device=dev).bfloat16()
        flat = x.reshape(-1, c.hidden_size)
        got = moe(x).reshape(flat.shape).float()
        sel, w, counts = moe.route(flat)
        loop = lfm2.looped_experts(flat, sel, w, moe.experts).float()
        moe32 = lfm2.SparseMoe(dataclasses.replace(c, dtype="float32"), 0).to(dev)
        moe32.load_state_dict(moe.state_dict())
        exact = lfm2.looped_experts(flat.float(), sel, w, moe32.experts)
    scale = loop.abs().max()
    assert (got - loop).abs().max() <= 2e-2 * scale
    assert (got - exact).abs().max() <= 2e-2 * scale


def _eager(model, b):
    with torch.inference_mode():
        return step._eval_forward(model, b)


# the bf16 forward's question-centred logits against fp32's, rms over rms:
# 0.06-0.09 on three batches at this size on the CPU, where a dropped causal
# mask reads 0.22-0.37 and one routed expert fewer 0.19-0.21
MID_LOGITS_REL_RMS = 0.15


def centred(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=1, keepdim=True)


@pytest.mark.cuda
def test_card_bf16_forward_against_the_plain_path(mid, monkeypatch):
    """The bf16 forward on the card (the dense-bias kernel, the grouped
    products) against the plain path: the same weights in fp32 on the CPU
    (the attention ops' plain versions, the per-expert loop).  Every
    dense-bias launch of that forward is held against its plain version on
    its own q, k, v and [B, 1, L, L] plane, and every MoE layer's grouped
    products against the per-expert loop on the layer's own input, both at
    2e-2 of max |plain|."""
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )

    model, batch, cfg = mid
    b = batch(0)
    held, moe_inputs = [], []
    launch = fused_attention.launch

    def hold(q, k, v, bias):
        got = launch(q, k, v, bias)
        want = fused_attention_plain(q, k, v, bias).float()
        held.append((tuple(q.shape), tuple(bias.shape),
                     ((got.float() - want).abs().max() / want.abs().max()).item()))
        return got

    monkeypatch.setattr(fused_attention, "launch", hold)
    hooks = [m.register_forward_pre_hook(lambda mod, args: moe_inputs.append((mod, args[0])))
             for m in model.modules() if isinstance(m, lfm2.SparseMoe)]
    try:
        got = _eager(model, b)["logits"].float().cpu()
    finally:
        for h in hooks:
            h.remove()
    rows, L = b["r_input_ids"].shape[0], cfg.total_prefix_len + cfg.roberta_len
    assert [(q, bias) for q, bias, _ in held] == [((rows, L, MID.num_attention_heads,
                                                    MID.head_dim), (rows, 1, L, L))] * 2
    assert max(err for *_, err in held) <= 2e-2, held
    assert len(moe_inputs) == MID.num_moe_layers
    with torch.inference_mode():
        for moe, x in moe_inputs:
            flat = x.reshape(-1, MID.hidden_size)
            sel, w, counts = moe.route(flat)
            grouped = lfm2.grouped_experts(flat, sel, w, counts,
                                           *moe.stacked_weights(flat.dtype)).float()
            loop = lfm2.looped_experts(flat, sel, w, moe.experts).float()
            assert (grouped - loop).abs().max() <= 2e-2 * loop.abs().max()

    cfg32 = cfg.with_dtype("float32")
    plain = ModCRModel(cfg32, device="meta")
    plain.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()},
                          strict=True, assign=True)
    with torch.no_grad():
        want = plain.eval()({k: v.cpu() for k, v in b.items()}).logits
    rel = (centred(got - want).pow(2).mean().sqrt() / centred(want).pow(2).mean().sqrt()).item()
    print(f"bf16 card against fp32 CPU: rms {rel:.4f} of the centred logits' rms")
    assert torch.isfinite(got).all() and rel <= MID_LOGITS_REL_RMS


@pytest.mark.cuda
def test_card_replays_bit_equal_to_eager_over_b0_b1_b2_b1(mid, monkeypatch):
    model, batch, _ = mid
    graphs = SegmentedGraphs(step._eval_forward)
    monkeypatch.setattr(step, "EVAL_GRAPHS", graphs)
    kinds = ("step.graph.eager", "step.graph.captures", "step.graph.replays")
    batches = [batch(i) for i in range(3)]
    start = [profiling.counter(k) for k in kinds]
    for i in (0, 1, 2, 1):
        want = _eager(model, batches[i])
        got = step.eval_step(model, batches[i])
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    assert [profiling.counter(k) - s for k, s in zip(kinds, start)] == [1, 1, 2]


@pytest.mark.cuda
def test_card_capture_holds_the_grouped_products(mid, monkeypatch):
    """After the capture no call runs eagerly, and a replay launches the
    grouped products from inside a segment: no host call of them."""
    model, batch, _ = mid
    graphs = SegmentedGraphs(step._eval_forward)
    monkeypatch.setattr(step, "EVAL_GRAPHS", graphs)
    b = batch(0)
    step.eval_step(model, b)
    step.eval_step(model, b)
    eager = profiling.counter("step.graph.eager")
    # 2 attention layers on the dense-bias op, the tiny towers' stage-mask launches
    assert sum(1 for op, _, _ in graphs.graph(model).ops
               if "dense_attention" in str(op)) == 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step.eval_step(model, b)
        torch.cuda.synchronize()
    assert profiling.counter("step.graph.eager") == eager
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not any("grouped_mm" in n for n in host)
    kernels = [n for n in device if any(k in n.lower() for k in EXPERT_KERNELS)]
    assert len(kernels) == 3 * 2 * MID.num_moe_layers, sorted(set(device))
