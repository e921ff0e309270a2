"""Attention, mask and chunk operations of the PyTorch port.

Importing the package registers the three kernels' dispatcher ops
(``torch.ops.modcr_torch.{spec_attention,dense_attention,flash_bwd}``) with
their gradients, whichever of its modules is imported first.
"""

from multimodal_context_reasoning_torch.ops import (  # noqa: F401
    flash,
    fused_attention,
    spec_attention,
)
