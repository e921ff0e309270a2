"""The ``generate`` front end (port of the JAX package's
``generation/api.py``, its greedy and sample modes).

The JAX function jit-compiles the chosen decoder into one program; here the
decoders run eagerly, one launch per op, with no host read inside the loop
(generation/decode.py).  ``mode="beam"`` and ``mode="cbs"`` (beam sampling
and the FSM-constrained beam search) raise until they are ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_context_reasoning_torch.generation.decode import greedy_decode, sample_decode
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder


def generate(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,
    prompt_len: torch.Tensor,
    *,
    mode: str = "greedy",            # greedy | sample (beam | cbs not ported)
    memory: Optional[torch.Tensor] = None,
    memory_mask: Optional[torch.Tensor] = None,
    max_len: int = 50,
    eos_id: int = 50256,
    pad_id: int = 0,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_len], lengths [B])."""
    common = dict(memory=memory, memory_mask=memory_mask, max_len=max_len,
                  eos_id=eos_id, pad_id=pad_id)
    if mode == "greedy":
        return greedy_decode(decoder, prompt_ids, prompt_len, **common)
    if mode == "sample":
        if generator is None:
            raise ValueError("mode='sample' requires a torch.Generator")
        return sample_decode(decoder, prompt_ids, prompt_len, generator=generator,
                             temperature=temperature, top_k=top_k, top_p=top_p, **common)
    if mode in ("beam", "cbs"):
        raise NotImplementedError(
            f"mode={mode!r}: beam, CBS/FSM and constraint decoding are not ported yet "
            "(ROADMAP Queue 1 item 7)")
    raise ValueError(f"unknown mode {mode!r}")
