"""Entry commands of the port: ``python -m
multimodal_context_reasoning_torch.cli.run_pmr`` and ``...cli.run_vcr``."""
