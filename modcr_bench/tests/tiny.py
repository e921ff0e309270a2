"""Small configurations for the benchmark's CPU tests: the program's tiny
widths (``ModCRConfig.tiny()``) at text 64 and RoBERTa 100 tokens, long
enough that the four candidates of a question differ (at the tiny 16 / 20
they are cut to the same tokens and tie), and small pools and batches."""

from __future__ import annotations

import copy
import json

import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig

from modcr_bench import harness
from modcr_bench.trace import Tracer


def configs():
    m = json.loads(ModCRConfig.tiny().to_json())
    m.update(text_len=64, roberta_len=100)
    return {"modcr_pmr": {"name": "modcr_pmr", "kind": "modcr", "model": m}}


# fp32 at tiny widths: sound runs read under 1e-5 on every gap, and no
# logit is LIMIT off
LIMIT = 1e-4


def cell(name: str, **traffic):
    """The cell's file at a CPU-sized pool and batch, its limits at
    :data:`LIMIT`."""
    c = copy.deepcopy(harness.load_cell(name))
    small = {"pool": 32, "questions_per_batch": 4}
    c["traffic"].update({k: v for k, v in small.items() if k in c["traffic"]}, **traffic)
    c["limits"] = {k: 0.0 if k == "logits_off" else LIMIT for k in c["limits"]}
    if "check_tau" in c["traffic"]:
        c["traffic"]["check_tau"] = LIMIT
    return c


def session(name: str, seed: int = 2**31 + 11, *, seconds: float = 0.5, **traffic):
    """A cell's session on the CPU, set up, run for ``seconds`` and
    released; returns (session, window stats)."""
    torch.manual_seed(0)
    c = cell(name, **traffic)
    s = harness.load_module("traffic", c["runner"]).Session(
        c, configs()[c["config"]], seed, "cpu")
    s.setup()
    stats = s.window(seconds, Tracer(False))
    s.release()
    return s, stats
