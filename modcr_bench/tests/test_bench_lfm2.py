"""The LFM2 reasoner's cell (configuration kind ``modcr_lfm2``) on the CPU at
tiny widths, fp32: the work counts against the flop counter and a hand
count, the reference's parameter names against the program's, the
configuration file against the published config, and the runner's check
passing a sound run and failing each control.  Marked ``cuda``, the
controls at the cell's own size, printed for PERF.md:

    python -m pytest modcr_bench/tests/test_bench_lfm2.py -m cuda -s
"""

from __future__ import annotations

import copy
import gc
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.models.modcr import ModCRModel

from modcr_bench import harness, lfm2_counts, lfm2_params
from modcr_bench.reference import data
from modcr_bench.reference import lfm2 as reference
from modcr_bench.tests import tiny
from modcr_bench.tests.test_bench_control import _fails, _report, half_eval, run_session
from modcr_bench.trace import Tracer
from modcr_bench.traffic import evaluate, synthetic

CELL = "pmr_lfm2moe_eval_b32"
SEEDS = [int(s) for s in os.environ.get("BENCH_CONTROL_SEEDS",
                                        "2147483911,2147483912,2147483913").split(",")]
TINY_LFM2 = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                 num_hidden_layers=6, num_attention_heads=4, num_key_value_heads=2,
                 num_dense_layers=2, num_experts=8, num_experts_per_tok=2,
                 layer_types=["conv", "conv", "full_attention", "conv", "conv", "full_attention"],
                 conv_L_cache=3, conv_bias=False, rope_theta=1000000, norm_eps=1e-5,
                 norm_topk_prob=True, use_expert_bias=True, routed_scaling_factor=1,
                 max_position_embeddings=128000, initializer_range=0.02, dtype="float32")


def tiny_conf():
    m = tiny.configs()["modcr_pmr"]["model"]
    m = {k: v for k, v in m.items() if k != "roberta"}
    m.update(reasoner="lfm2_moe", lfm2=dict(TINY_LFM2), roberta_len=40)
    return {"name": "modcr_pmr_lfm2_8b_a1b", "kind": "modcr_lfm2", "model": m}


def tiny_cell(**traffic):
    c = copy.deepcopy(harness.load_cell(CELL))
    c["traffic"].update(pool=32, questions_per_batch=4, check_tau=tiny.LIMIT, **traffic)
    c["limits"] = {"logits_off": 0.0}
    return c


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_config_file_holds_the_published_config():
    conf = harness.load_config(harness.load_cell(CELL)["config"])
    lf = conf["model"]["lfm2"]
    for key, value in lf.items():
        if key not in ("dtype", "initializer_range"):
            assert conf[key] == value, key
    assert conf["reduced"] == [] and lf["dtype"] == "bfloat16"
    cfg = ModCRConfig.from_json(json.dumps(conf["model"]))
    assert cfg.lfm2.layer_types.count("full_attention") == 6 and cfg.lfm2.num_moe_layers == 22


def test_parameter_names_are_the_programs():
    m = tiny_conf()["model"]
    net = ModCRModel(ModCRConfig.from_json(json.dumps(m)), device="cpu")
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == dict(
        lfm2_params.modcr_lfm2(m))


def test_model_flops_match_the_flop_counter():
    """The reference's products at tiny widths, less the three convolution
    taps ``F.conv1d`` counts (padded by K - 1 on both sides) and the
    counts leave out."""
    m = tiny_conf()["model"]
    geo = reference.geometry(m)
    feats, exs = synthetic.make_pool(3, 3, geo, labels=True)
    P = lfm2_params.make(m, 1, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        reference.score(m, P, exs, feats, "cpu")
    c, rows = m["lfm2"], 3 * m["num_labels"]
    L, K = 2 * m["prefix_len"] + m["roberta_len"], c["conv_L_cache"]
    taps = c["layer_types"].count("conv") * 2 * rows * c["hidden_size"] * (L + K - 1) * K
    assert lfm2_counts.model_flops(m, 3) == fc.get_total_flops() - taps


def test_expert_work_by_hand():
    m = tiny_conf()["model"]
    T = 2 * 4 * (10 + 40)                    # 2 questions x 4 candidates x 50 positions
    layers, E, d, f, k = 4, 8, 64, 32, 2
    nbytes, flops = lfm2_counts.expert_work(m, 2)
    assert flops == layers * 2 * T * k * 3 * d * f
    assert nbytes == layers * 2 * (E * 3 * d * f + T * k * (d + 3 * f + d))
    assert lfm2_counts.expert_bound_seconds(m, 2) == pytest.approx(
        layers * max(nbytes / layers / 3.35e12, flops / layers / 989e12))


def test_full_size_counts():
    """The published geometry: 59.6 TFLOP a batch of 32 questions, 34.2 of
    them in the routed experts, bound by FLOPs at 1.57 ms a layer."""
    conf = harness.load_config(harness.load_cell(CELL)["config"])
    m = conf["model"]
    assert lfm2_counts.model_flops(m, 32) / 1e12 == pytest.approx(59.6, abs=0.05)
    assert lfm2_counts.expert_work(m, 32)[1] / 1e12 == pytest.approx(34.23, abs=0.01)
    assert lfm2_counts.expert_bound_seconds(m, 32) / 22 == pytest.approx(1.573e-3, rel=1e-3)


def layer_imbalance(m, P, exs, feats):
    """The busiest expert's tokens over its layer's mean, each MoE layer's,
    when the reference runs ``exs``."""
    c, out = m["lfm2"], []

    def route(pre, s):
        top = (s + P[pre + "expert_bias"]).topk(c["num_experts_per_tok"], dim=-1).indices
        load = torch.bincount(top.reshape(-1), minlength=c["num_experts"]).double()
        out.append((load.max() / load.mean()).item())

    b = {k: torch.from_numpy(v) for k, v in
         data.collate(exs, feats, reference.geometry(m)).items()}
    with torch.no_grad():
        reference.forward(P, m, b, route=route)
    return out


def test_balance_evens_the_expert_load_and_sets_only_the_biases():
    """``lfm2_params.balance`` brings every MoE layer's busiest expert to
    near its layer's mean on the calibration batch, and lower on other
    questions too, and changes nothing but the expert biases."""
    m = tiny_conf()["model"]
    feats, exs = synthetic.make_pool(2147483977, 32, reference.geometry(m), labels=True)
    P = lfm2_params.make(m, 2147483977, "cpu")
    drawn = {k: v.clone() for k, v in P.items()}
    before = layer_imbalance(m, P, exs[16:], feats)
    biases = lfm2_params.balance(m, P, exs[:16], feats, "cpu")
    assert sorted(biases) == sorted(k for k in P if k.endswith("expert_bias"))
    assert all(torch.equal(P[k], drawn[k]) for k in P if k not in biases)
    assert all(torch.equal(P[k], v) for k, v in biases.items())
    calibrated = layer_imbalance(m, P, exs[:16], feats)
    other = layer_imbalance(m, P, exs[16:], feats)
    assert max(calibrated) <= 1.05, calibrated
    assert sum(other) / len(other) < sum(before) / len(before), (before, other)


def controlled(c, control, monkeypatch):
    """``c`` under ``control``: the runner's own, or half of each window
    batch left out (the window is ``evaluate``'s)."""
    if control == "half":
        monkeypatch.setattr(evaluate, "eval_step", half_eval(evaluate.eval_step))
    elif control is not None:
        c["traffic"]["control"] = control
    return c


@pytest.mark.parametrize("control", [None, "top3", "no_expert_bias", "fp8", "half"])
def test_the_check_passes_sound_runs_and_fails_each_control(control, monkeypatch):
    c = controlled(tiny_cell(), control, monkeypatch)
    values = run_session(c, tiny_conf(), 5, "cpu", 0.3)
    assert _fails(c, values) == (control is not None), values


# --- on the card, at the cell's own size ---------------------------------------

def run_freed(cell, conf, seed, device, seconds):
    """``run_session``, freeing the program's state before the check as the
    harness does: one process runs many sessions of a 35 GB model here, and
    each capture's graph pool must go back to the card with its model."""
    s = harness.load_module("traffic", cell["runner"]).Session(cell, conf, seed, device)
    s.setup()
    s.window(seconds, Tracer(False))
    s.release()
    gc.collect()
    torch.cuda.empty_cache()
    return s.check()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("control", ["top3", "no_expert_bias", "fp8", "half"])
def test_controls_on_the_card(control, seed, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = controlled(harness.load_cell(CELL), control, monkeypatch)
    values = run_freed(c, harness.load_config(c["config"]), seed, torch.device("cuda", 0), 3.0)
    _report(control, CELL, seed, values)
    assert _fails(c, values)
