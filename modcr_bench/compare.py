"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference.  A check computes several numbers; those the
cell's file gives a limit are compared (each set from readings of sound
runs, of the lower-precision control and of planted faults: PERF.md), the
others are printed for the record.

Scoring (each sampled question's four logits):

- ``logits_off``: how many sampled candidates' logits, each taken relative
  to its question's mean (the answer's probabilities and ranking do not
  see a shift common to its four), lie more than ``tau`` from the
  reference's;
- ``logit_gap``: the widest |logit - reference logit|;
  ``logit_gap_c``, ``logit_rms_c``: the widest and the root-mean-square
  gap of the question-centred logits.
"""

from __future__ import annotations

from typing import Dict

import torch


def scoring(program: torch.Tensor, reference: torch.Tensor, tau: float) -> Dict[str, float]:
    d = program.double() - reference.double()
    dc = d - d.mean(dim=1, keepdim=True)
    return {"logits_off": float((dc.abs() > tau).sum()),
            "logit_gap": float(d.abs().max()),
            "logit_gap_c": float(dc.abs().max()),
            "logit_rms_c": float(dc.pow(2).mean().sqrt())}
