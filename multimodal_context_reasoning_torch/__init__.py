"""PyTorch/CUDA port of ModCR, beside the JAX package it is held against.

The package imports torch and numpy only: nothing of JAX and nothing of
``multimodal_context_reasoning_tpu``.  Its layout mirrors the JAX package's
so each module's counterpart is found under the same path.  The stage-mask
attention runs as a hand-written CUDA kernel on the GPU
(``ops/spec_attention.py``, ``csrc/spec_attention.cu``); on a CPU tensor the
same function runs as plain PyTorch, which is what the tests hold against
the JAX package.
"""

__version__ = "0.1.0"
