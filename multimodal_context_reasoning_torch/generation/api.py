"""The ``generate`` front end (port of the JAX package's
``generation/api.py``): greedy, sampled, beam-sampled and FSM-constrained
(CBS) decoding over the port's GPT-2 decoder.

The JAX function jit-compiles the chosen decoder into one program; here the
decoders run eagerly, one launch per op.  Greedy and sampled decoding read
nothing back to the host inside their loops (generation/decode.py); beam
sampling reads whether every question is done once per step, where JAX's
``lax.while_loop`` tests it (generation/beam.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_context_reasoning_torch.generation.beam import constrained_beam_sample
from multimodal_context_reasoning_torch.generation.decode import greedy_decode, sample_decode
from multimodal_context_reasoning_torch.generation.fsm import (
    fsm_decode_gpt2,
    select_best_beam_with_constraints,
)
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder


def _cbs_select(beams, logp, num_constraints, min_satisfy: int, eos_id: int):
    tokens, _ = select_best_beam_with_constraints(beams, logp, num_constraints, min_satisfy,
                                                  (eos_id,))
    # the length convention of decode.py: up to AND INCLUDING the first eos
    # (the lattice pads the tail with eos; a beam that never emitted eos
    # keeps max_len)
    before = torch.cumprod((tokens != eos_id).long(), dim=-1).sum(dim=-1)
    return tokens, torch.clamp(before + 1, max=tokens.shape[-1])


def generate(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,
    prompt_len: torch.Tensor,
    *,
    mode: str = "greedy",            # greedy | sample | beam | cbs
    memory: Optional[torch.Tensor] = None,
    memory_mask: Optional[torch.Tensor] = None,
    max_len: int = 50,
    eos_id: int = 50256,
    pad_id: int = 0,
    generator: Optional[torch.Generator] = None,
    # sampling
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    # beam
    num_beams: int = 5,
    constraint_mask: Optional[torch.Tensor] = None,
    constraint_factor: float = 0.8,
    repetition_penalty: float = 1.0,
    length_penalty: float = 1.0,
    # cbs (FSM lattice, generation/fsm.py)
    fsm_adjacency: Optional[torch.Tensor] = None,    # [B, S, S, V] bool
    num_constraints: Optional[torch.Tensor] = None,  # [B] int
    min_constraints_to_satisfy: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_len], lengths [B])."""
    common = dict(memory=memory, memory_mask=memory_mask, eos_id=eos_id, pad_id=pad_id)
    if mode == "greedy":
        return greedy_decode(decoder, prompt_ids, prompt_len, max_len=max_len, **common)
    if mode == "sample":
        if generator is None:
            raise ValueError("mode='sample' requires a torch.Generator")
        return sample_decode(decoder, prompt_ids, prompt_len, generator=generator,
                             temperature=temperature, top_k=top_k, top_p=top_p,
                             max_len=max_len, **common)
    if mode == "beam":
        if generator is None:
            raise ValueError("mode='beam' requires a torch.Generator (beam *sampling*)")
        return constrained_beam_sample(
            decoder, prompt_ids, prompt_len, generator=generator, num_beams=num_beams,
            max_steps=max_len, constraint_mask=constraint_mask,
            constraint_factor=constraint_factor, repetition_penalty=repetition_penalty,
            top_k=top_k or 50, length_penalty=length_penalty, **common)
    if mode == "cbs":
        # the reference's use_cbs branch (modeling_bert.py:1018-1034): the
        # lattice search, then the top length-normalized beam among the
        # constraint-satisfying states
        if fsm_adjacency is None:
            raise ValueError("mode='cbs' requires fsm_adjacency "
                             "(generation.fsm.FiniteStateMachineBuilder.build)")
        if num_constraints is None:
            raise ValueError("mode='cbs' requires num_constraints ([B] ints — the "
                             "reference passes it alongside fsm, modeling_bert.py:1028)")
        beams, logp = fsm_decode_gpt2(decoder, prompt_ids, prompt_len, fsm_adjacency,
                                      memory=memory, memory_mask=memory_mask,
                                      num_beams=num_beams, max_steps=max_len,
                                      eos_ids=(eos_id,))
        return _cbs_select(beams, logp, num_constraints, min_constraints_to_satisfy, eos_id)
    raise ValueError(f"unknown mode {mode!r}")
