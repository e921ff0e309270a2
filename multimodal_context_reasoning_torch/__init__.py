"""PyTorch/CUDA port of ModCR, beside the JAX package it is held against.

The package imports torch and numpy only: nothing of JAX and nothing of
``multimodal_context_reasoning_tpu``.  Its layout mirrors the JAX package's
so each module's counterpart is found under the same path.  Attention runs
as hand-written CUDA kernels on the GPU: the stage-mask forward
(``ops/spec_attention.py``, ``csrc/spec_attention.cu``), the dense-bias
forward (``ops/fused_attention.py``, ``csrc/fused_attention.cu``) and the
backward of both (``ops/flash.py``, ``csrc/flash_bwd.cu``).  On a CPU tensor
each runs as plain PyTorch, which is what the tests hold against the JAX
package.
"""

__version__ = "0.1.0"
