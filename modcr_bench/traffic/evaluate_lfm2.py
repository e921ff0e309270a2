"""Traffic runner ``evaluate_lfm2``: ``evaluate``'s scoring (the program's
``DataLoader``, prefetch on and shuffled from the seed, feeding
``train/step.py::eval_step``; the memo; the check over window batches) for
ModCR with the LFM2 reasoner (configuration kind ``modcr_lfm2``).

- Set-up holds one copy of the weights: the program's model is built on
  the meta device and the seed's flat draw (``lfm2_params.make``) is
  assigned to it, so the card never holds a second 35 GB.  Before that,
  ``lfm2_params.balance`` sets the expert biases on the pool's first
  ``CALIBRATION_QUESTIONS`` questions; the check's reference takes the
  same biases.
- The window reads the program's device tally of tokens per expert and
  MoE layer (``utils/profiling.py::read_tally``; it counts while the
  program's spans are on, in traced runs) into ``stats["expert_tokens"]``.
- The check runs ``reference/lfm2.py`` on the seed's weights again.

Parameters: ``evaluate``'s, and ``control``, the stand-ins for a wrong
program that the limits must fail: ``"top3"`` routes each token of the
program to one expert fewer; ``"no_expert_bias"`` zeroes the program's
expert biases, so they no longer select; ``"fp8"`` checks, in the
program's place, the reference computed with its reasoner's products in
float8 (e4m3), the precision below the configuration's bf16.  The fp32
reference the check compares with never sees a control.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# the program's LFM2 reasoner: a checkout without it fails here, at once
import multimodal_context_reasoning_torch.models.lfm2 as lfm2
from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.train.step import eval_step
from multimodal_context_reasoning_torch.utils import profiling

from modcr_bench import compare, lfm2_params, port
from modcr_bench.reference import lfm2 as reference
from modcr_bench.traffic import evaluate, synthetic

CALIBRATION_QUESTIONS = 16      # the expert biases' calibration batch: 8,832 tokens


def build_model(m, P) -> torch.nn.Module:
    """The program's model at model dict ``m`` holding the tensors of ``P``
    themselves (no copy)."""
    net = ModCRModel(ModCRConfig.from_json(json.dumps(m)), device="meta")
    net.load_state_dict(P, strict=True, assign=True)
    return net


class Session(evaluate.Session):
    def __init__(self, cell, conf, seed: int, device):
        self.cell, self.conf, self.seed, self.device = cell, conf, seed, torch.device(device)
        self.kind = conf["kind"]
        self.t = cell["traffic"]
        self.model_dict = port.model_dict(conf, cell)
        self.geo = reference.geometry(self.model_dict)

    def setup(self) -> None:
        t, self.phases = self.t, port.Phases()
        self.feats, self.examples = synthetic.make_pool(
            self.seed, t["pool"], self.geo, labels=True,
            multi_label_share=t.get("multi_label_share", 0.2))
        self.phases.mark("traffic")
        m, control = self.model_dict, t.get("control")
        if control == "top3":
            m = port.merged(m, {"lfm2": {"num_experts_per_tok":
                                         m["lfm2"]["num_experts_per_tok"] - 1}})
        P = lfm2_params.make(self.model_dict, self.seed, self.device)
        self.expert_bias = lfm2_params.balance(
            self.model_dict, P, self.examples[:CALIBRATION_QUESTIONS], self.feats, self.device)
        self.model = build_model(m, P)
        del P
        if control == "no_expert_bias":
            for name, buf in self.model.named_buffers():
                if name.endswith("expert_bias"):
                    buf.zero_()
        self.phases.mark("model")
        memo = t.get("memo", False)
        self.dataset = port.Dataset(self.examples, self.feats, self.geo, memo=memo)
        if memo:
            for i in range(len(self.examples)):
                self.dataset._featurize_cached(i)
            self.phases.mark("featurize")
        loader = DataLoader(self.dataset, t["questions_per_batch"], shuffle=True,
                            seed=self.seed, drop_last=True)
        self.batches = port.epochs(loader)
        self.warm = t.get("warmup_batches", 2)
        for _ in range(self.warm):
            eval_step(self.model, port.to_device(next(self.batches), self.device))
        port.sync(self.device)
        self.phases.mark("warm_up")

    def window(self, seconds: float, tracer) -> dict:
        profiling.read_tally(lfm2.EXPERT_TALLY)           # the warm-up's counts
        stats = super().window(seconds, tracer)
        tally = profiling.read_tally(lfm2.EXPERT_TALLY)
        if tally is not None:
            stats["expert_tokens"] = tally.tolist()
        return stats

    def check(self) -> dict:
        """Scoring's numbers (compare.py) over ``check_batches`` window
        batches drawn from the seed, against ``reference/lfm2.py`` on the
        same examples and the seed's weights."""
        n = len(self.logits)
        rng = np.random.default_rng([self.seed, 1])
        picks = sorted(rng.choice(n, size=min(self.t["check_batches"], n), replace=False))
        exs = [self.examples[j] for k in picks for j in self.taken[self.warm + k]]
        P = lfm2_params.make(self.model_dict, self.seed, self.device)
        P.update(self.expert_bias)
        ref = reference.score(self.model_dict, P, exs, self.feats, self.device)
        if self.t.get("control") == "fp8":
            program = reference.score(self.model_dict, P, exs, self.feats, self.device,
                                      low=torch.float8_e4m3fn)
        else:
            program = torch.cat([self.logits[k] for k in picks])
        del P
        return compare.scoring(program, ref, self.t["check_tau"])
