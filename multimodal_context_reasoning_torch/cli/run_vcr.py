"""VCR trainer entry point (port of the JAX package's ``cli/run_vcr.py``;
run_vcr_ModCR.py parity).

Differences from PMR baked in per the reference: RoBERTa body frozen
(run_vcr_ModCR.py:783-787 — only embeddings + pooler train), default
gradient accumulation 4 (:605).
"""

from __future__ import annotations

import sys

from multimodal_context_reasoning_torch.cli.run_pmr import main as _main
from multimodal_context_reasoning_torch.data.vcr import VCRDataset, load_vcr_json


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--gradient_accumulation_steps") for a in argv):
        argv += ["--gradient_accumulation_steps", "4"]  # run_vcr_ModCR.py:605
    return _main(argv, task="vcr", dataset_cls=VCRDataset, load_fn=load_vcr_json)


if __name__ == "__main__":
    main()
