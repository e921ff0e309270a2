"""Greedy and sampled KV-cached decoding (port of the JAX package's
``generation/decode.py``).

One prefill pass over the right-padded prompt writes its K/V into a static
cache (models/gpt2.py); then exactly ``max_len`` single-token steps follow,
each writing at slot ``Lp + t`` with position ``prompt_len + t``.  A step
keeps the JAX scan's order: the token fed at step ``t`` is emitted (``pad_id``
once the row is done), the row counts as active for that step, and only then
does ``done`` take in whether that token was ``eos_id``.  So a length is the
number of active steps, the eos included: it is positional, not
``tokens != pad_id`` (GPT-2's pad 50256 is its eos too).

The loop is ``max_len`` Python iterations over device tensors with no read
back to the host; sampling draws from a seeded ``torch.Generator`` through
the exponential race (``argmax(p / Exp(1))``, the draw ``torch.multinomial``
makes for one sample, without its host-side check of ``p``).  Draws cannot
match JAX's PRNG: the filter is held to JAX's exactly, top-k = 1 sampling to
greedy, and the rest by determinism and support.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder


def _decode(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,
    prompt_len: torch.Tensor,
    pick: Callable[[torch.Tensor], torch.Tensor],
    *,
    memory: Optional[torch.Tensor],
    memory_mask: Optional[torch.Tensor],
    max_len: int,
    eos_id: int,
    pad_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Lp = prompt_ids.shape
    dev = prompt_ids.device
    prompt_len = prompt_len.to(dev, torch.long)
    cache = decoder.new_cache(B, Lp + max_len, dev)
    # readable cache slots: real prompt tokens and everything generated
    pos = torch.arange(Lp + max_len, device=dev)[None, :]
    cache_valid = ((pos < prompt_len[:, None]) | (pos >= Lp)).float()
    cross = None
    if memory is not None and decoder.config.add_cross_attention:
        cross = decoder.cross_kv(memory)

    logits, cache = decoder(prompt_ids, memory_mask=memory_mask, cross_kv=cross,
                            cache=cache, cache_index=0, cache_valid=cache_valid)
    # the last real prompt token's logits give the first generated token
    last = logits[torch.arange(B, device=dev), prompt_len - 1]        # [B, V]
    tok = pick(last)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks, active = [], []
    for t in range(max_len):
        logits, cache = decoder(tok[:, None], position_offset=prompt_len + t,
                                memory_mask=memory_mask, cross_kv=cross, cache=cache,
                                cache_index=Lp + t, cache_valid=cache_valid)
        nxt = pick(logits[:, 0])
        toks.append(torch.where(done, pad_id, tok))
        active.append(~done)
        done = done | (tok == eos_id)
        tok = nxt
    return torch.stack(toks, dim=1), torch.stack(active, dim=1).sum(dim=1)


@torch.no_grad()
def greedy_decode(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,        # [B, Lp] right-padded prompt
    prompt_len: torch.Tensor,        # [B] real prompt lengths
    *,
    memory: Optional[torch.Tensor] = None,
    memory_mask: Optional[torch.Tensor] = None,
    max_len: int = 50,
    eos_id: int = 50256,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_len], lengths [B])."""
    return _decode(decoder, prompt_ids, prompt_len, lambda lg: lg.argmax(dim=-1),
                   memory=memory, memory_mask=memory_mask, max_len=max_len,
                   eos_id=eos_id, pad_id=pad_id)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """HF ``top_k_top_p_filtering``: keep the top-k logits and/or the
    smallest prefix of the sorted distribution whose cumulative probability
    exceeds ``top_p`` (the first token always kept); the rest become -1e9.
    ``top_p >= 1`` skips the sort."""
    neg = -1e9
    if 0 < top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cutoff = torch.cumsum(probs, dim=-1) - probs > top_p
        threshold = torch.where(cutoff, torch.inf, sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, neg, logits)
    return logits


@torch.no_grad()
def sample_decode(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,
    prompt_len: torch.Tensor,
    *,
    generator: torch.Generator,
    memory: Optional[torch.Tensor] = None,
    memory_mask: Optional[torch.Tensor] = None,
    max_len: int = 50,
    eos_id: int = 50256,
    pad_id: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sampling with temperature and the top-k/top-p filter;
    every draw comes from ``generator`` (on the tokens' device)."""
    temp = max(float(temperature), 1e-6)

    def pick(lg):
        probs = torch.softmax(top_k_top_p_filter(lg.float() / temp, top_k, top_p), dim=-1)
        race = torch.empty_like(probs).exponential_(generator=generator)
        return (probs / race).argmax(dim=-1)

    return _decode(decoder, prompt_ids, prompt_len, pick, memory=memory,
                   memory_mask=memory_mask, max_len=max_len, eos_id=eos_id, pad_id=pad_id)
