"""Traffic runner ``evaluate``: scoring as ``run_pmr --do_test`` and
``Trainer.evaluate`` do it.  The program's ``DataLoader`` (prefetch on,
shuffled from the seed) feeds ``train/step.py::eval_step`` with
``questions_per_batch`` questions a batch, from a pool of labelled
synthetic requests drawn from the seed.  Without ``memo`` every batch is
featurized in the timed path, as one pass of ``--do_test`` is; with it
the dataset's memo holds the pool, featurized during set-up, as it does
for the held-out set that ``Trainer.evaluate`` scores again and again
during training.

Parameters (the cell's ``traffic``): ``questions_per_batch``, ``pool``,
``memo``, ``multi_label_share``, ``warmup_batches``, ``check_batches`` (window
batches, drawn from the seed, whose logits the reference recomputes),
``check_tau`` (compare.py's ``tau``), and ``quantize`` ("int8": the
program's W8A8 route, the control).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.train.step import eval_step

from modcr_bench import compare, port, reference, weights
from modcr_bench.traffic import synthetic


class Session:
    def __init__(self, cell, conf, seed: int, device):
        self.cell, self.conf, self.seed, self.device = cell, conf, seed, torch.device(device)
        self.kind = conf["kind"]
        self.t = cell["traffic"]
        self.model_dict = port.model_dict(conf, cell)
        self.geo = reference.geometry(self.kind, self.model_dict)

    def setup(self) -> None:
        t, self.phases = self.t, port.Phases()
        self.feats, self.examples = synthetic.make_pool(
            self.seed, t["pool"], self.geo, labels=True,
            multi_label_share=t.get("multi_label_share", 0.2))
        self.phases.mark("traffic")
        m = port.quantized(self.model_dict) if t.get("quantize") == "int8" else self.model_dict
        self.model = port.build_model(self.conf, m, self.seed, self.device)
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
        logits, wait, i = [], 0.0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        starts = []
        while True:
            tracer.step(i)
            w0 = time.perf_counter()
            starts.append(w0)
            with record_function("bench.loader_wait"):
                batch = next(self.batches)
            wait += time.perf_counter() - w0
            with record_function("bench.to_device"):
                batch = port.to_device(batch, self.device)
            with record_function("bench.step"):
                logits.append(eval_step(self.model, batch)["logits"])
            i += 1
            if time.perf_counter() >= deadline:
                break
        tracer.finish(i)
        port.sync(self.device)
        seconds = time.perf_counter() - t0
        self.logits = [x.float().cpu() for x in logits]
        q = self.t["questions_per_batch"]
        return {"seconds": seconds, "steps": i, "score_examples": i * q, "attempted": i * q,
                "failed": 0, "loader_wait_s": wait,
                "step_s": [b - a for a, b in zip(starts, starts[1:] + [t0 + seconds])]}

    def release(self) -> None:
        self.batches.close()
        del self.model, self.batches
        self.taken = self.dataset.taken
        del self.dataset

    def check(self) -> dict:
        """Scoring's numbers (compare.py) over ``check_batches`` window
        batches drawn from the seed, against the fp32 reference on the same
        examples."""
        n = len(self.logits)
        rng = np.random.default_rng([self.seed, 1])
        picks = sorted(rng.choice(n, size=min(self.t["check_batches"], n), replace=False))
        exs = [self.examples[j] for k in picks for j in self.taken[self.warm + k]]
        P = weights.for_model(self.conf, self.model_dict, self.seed, self.device)
        ref = reference.score(self.kind, self.model_dict, P, exs, self.feats, self.device)
        del P
        return compare.scoring(torch.cat([self.logits[k] for k in picks]), ref,
                               self.t["check_tau"])
