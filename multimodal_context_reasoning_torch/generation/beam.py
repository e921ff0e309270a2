"""Constrained beam sampling (port of the JAX package's ``generation/beam.py``).

Reference semantics (modeling_vcr_chunkalign_v10.py:2194-2320 ``beam_sample``
+ ``BeamSearchScorer_constrained.process`` :1892-1966 + ``BeamHypotheses``
:1794-1839):

per step, for every open beam —
1. log-softmax the next-token logits;
2. repetition penalty on tokens already generated (HF semantics:
   ``s<0 ? s*p : s/p``);
3. add the running beam scores, top-k warp;
4. sample ``2·K`` candidates *without replacement* from the softmax over
   the flattened ``[K·V]`` score matrix (Gumbel top-k), then sort them by
   score descending;
5. walk the candidates in order: an EOS candidate ranked in the top K
   finalizes a hypothesis scored ``sum_logprobs / len^length_penalty``;
   a non-EOS candidate fills the next open beam slot, with its score
   multiplied by ``constrained`` when the token is in ``add_score_ids``
   (the boost compounds into all following steps, :1943-1944);
6. stop when every batch is done (worst kept hypothesis can no longer be
   beaten) or ``max_steps`` is reached.

As in the JAX function, step 5's walk is a masked top-k, sequences live in a
``[B, K, L_total]`` buffer, and the static KV cache of ``B·K`` rows is
prefilled once over the prompt and gathered by beam origin each step.  What
differs is form, not result:

- JAX runs the steps in ``lax.while_loop``.  Here they are a Python loop
  over device tensors that reads ``done.all()`` on the host once per step,
  so it stops at the step JAX's loop stops at: the length normalisation of
  the finalize reads the step count.
- The Gumbel noise comes from the caller's ``torch.Generator``
  (``-log(-log(u))``, ``u`` uniform and at least the smallest normal float,
  JAX's formula), or from ``noise`` [max_steps, B, K·V], a test seam that
  replays JAX's own draws.
- ``lax.top_k`` and ``jnp.argsort`` keep the lower index first on a tie,
  and ties are common: the K beams are copies at step 0, and -1e9 fills
  the warped-out scores.  ``torch.topk`` makes no such promise, so each
  ``top_k`` here is :func:`stable_top_k` (the first k of a stable
  descending sort) and each ``argsort`` a ``torch.sort(..., stable=True)``.
- The decoder memory's cross-attention keys and values are projected once
  per question (models/gpt2.py), not once per beam row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder, KVCache

NEG = -1.0e9
_LOW32 = 0xFFFFFFFF


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis of an fp32 tensor: the k largest
    values, largest first, a tie going to the lower index; that is the first
    k of ``torch.sort(x, descending=True, stable=True)``, without sorting.

    Each value and its index pack into one int64 key, the value's bits high
    (as an int32 that orders like the floats) and the complemented index low,
    so the keys are distinct and ``torch.topk`` of the keys is the stable
    order."""
    if x.dtype != torch.float32:
        raise TypeError(f"stable_top_k takes float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # negative floats order backwards as ints: flip their magnitude bits
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    keys.bitwise_left_shift_(32).bitwise_or_(
        _LOW32 - torch.arange(x.shape[-1], device=x.device))
    idx = _LOW32 - (torch.topk(keys, k, dim=-1).values & _LOW32)
    return x.gather(-1, idx), idx


def apply_repetition_penalty(
    logp: torch.Tensor,        # [N, V]
    seqs: torch.Tensor,        # [N, L] generated-so-far (pad elsewhere)
    valid: torch.Tensor,       # [N, L] bool, True where seqs holds a real token
    penalty: float,
) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: s<0 → s·p, else s/p, for every
    token id present in the sequence."""
    if penalty == 1.0:
        return logp
    present = torch.zeros_like(logp).scatter_reduce_(1, seqs, valid.to(logp.dtype), "amax") > 0
    penalized = torch.where(logp < 0, logp * penalty, logp / penalty)
    return torch.where(present, penalized, logp)


def top_k_warp(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k per row, everything else → -1e9 (TopKLogitsWarper)."""
    if k <= 0 or k >= scores.shape[-1]:
        return scores
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    return torch.where(scores < kth, NEG, scores)


class BeamState(NamedTuple):
    seqs: torch.Tensor          # [B, K, L_total] long
    beam_scores: torch.Tensor   # [B, K] f32 running sum of logprobs (boosted)
    cache: KVCache              # rows = B·K
    cur_len: int                # tokens generated so far
    fin_seqs: torch.Tensor      # [B, K, L_total]
    fin_scores: torch.Tensor    # [B, K] length-penalized, -1e9 if empty
    fin_count: torch.Tensor     # [B] long
    done: torch.Tensor          # [B] bool
    fin_lens: torch.Tensor      # [B, K] long, generated length at finalize
                                # (positional: `seq != pad_id` would miscount
                                # when pad is an emittable token, GPT-2's 50256)


class BeamContext(NamedTuple):
    """Static per-run inputs of one beam-advance (so tests can drive
    :func:`beam_select_step` on its own)."""

    p_ids: torch.Tensor          # [N, Lp] beam-expanded prompt ids
    prompt_valid: torch.Tensor   # [N, Lp] real-prompt-token mask
    prompt_len: torch.Tensor     # [B] per-example real prompt length
    cmask: torch.Tensor          # [B, V] constraint-token mask
    eos_id: int
    num_beams: int
    constraint_factor: float
    repetition_penalty: float
    top_k: int
    length_penalty: float


def beam_select_step(state: BeamState, logp_raw: torch.Tensor, ctx: BeamContext,
                     gumbel: torch.Tensor) -> BeamState:
    """One beam-advance given next-token log-probs [N, V] and Gumbel noise
    [B, K·V].

    The selection of ``BeamSearchScorer_constrained.process`` +
    ``BeamHypotheses.add/is_done`` (v10.py:1794-1966), vectorized as in JAX:

    - candidates are the 2K largest of score + noise (sampling without
      replacement), ordered by raw score desc (beam_sample, v10.py:2194-2320);
    - an EOS candidate ranked in the top K finalizes a hypothesis scored
      ``sum_logprobs / (prompt_len + t) ** length_penalty`` — the reference
      normalizes by the FULL input_ids length, prompt included (:1817);
    - non-EOS candidates fill beam slots in order; a constraint token's
      score is multiplied by ``constraint_factor`` AFTER selection
      (:1943-1944), compounding into later steps;
    - a batch is done when K hypotheses exist and the worst kept score
      beats the step's RAW best candidate score normalized at the current
      length (is_done, :1826-1839).

    The three ``lax.top_k`` are :func:`stable_top_k`, the ``argsort`` a stable
    sort: ties go to the lower index, as in JAX.
    """
    K = ctx.num_beams
    B, V = ctx.cmask.shape
    N = B * K
    L_total = state.seqs.shape[-1]
    t = state.cur_len
    dev = logp_raw.device

    gen = state.seqs.reshape(N, L_total)
    gen_valid = (torch.arange(L_total, device=dev) < t)[None].expand(N, L_total)
    full_seq = torch.cat([ctx.p_ids, gen], dim=1)
    full_valid = torch.cat([ctx.prompt_valid, gen_valid], dim=1)
    logp = apply_repetition_penalty(logp_raw, full_seq, full_valid, ctx.repetition_penalty)
    scores = logp + state.beam_scores.reshape(N)[:, None]            # [N, V]
    flat = top_k_warp(scores, ctx.top_k).reshape(B, K * V)

    # Sample 2K without replacement: the top 2K of the perturbed scores,
    # then ordered by raw score desc.
    _, idx = stable_top_k(flat + gumbel, 2 * K)                      # [B, 2K]
    cand_scores = flat.gather(1, idx)
    order = torch.sort(-cand_scores, dim=1, stable=True).indices
    idx = idx.gather(1, order)
    cand_scores = cand_scores.gather(1, order)
    origin = idx // V                                                # [B, 2K]
    token = idx % V

    is_eos = token == ctx.eos_id
    rank = torch.arange(2 * K, device=dev)[None]
    # reference length base: prompt + generated so far (the EOS itself is
    # never appended)
    hyp_len = torch.clamp(ctx.prompt_len.float() + float(t), min=1.0)[:, None]   # [B, 1]

    # ---- finished pool: EOS candidates ranked in the top K (:1934-1937)
    eos_scores = torch.where(is_eos & (rank < K),
                             cand_scores / hyp_len ** ctx.length_penalty, NEG)
    cand_seqs = state.seqs.gather(1, origin[..., None].expand(B, 2 * K, L_total))
    pool_scores = torch.cat([state.fin_scores, eos_scores], dim=1)
    pool_seqs = torch.cat([state.fin_seqs, cand_seqs], dim=1)
    # a hypothesis finalized now holds t generated tokens
    pool_lens = torch.cat([state.fin_lens, torch.full_like(eos_scores, t, dtype=torch.long)],
                          dim=1)
    top_scores, top_idx = stable_top_k(pool_scores, K)
    new_fin_seqs = pool_seqs.gather(1, top_idx[..., None].expand(B, K, L_total))
    new_fin_lens = pool_lens.gather(1, top_idx)
    new_fin_count = torch.clamp(state.fin_count + (eos_scores > NEG).sum(dim=1), max=K)
    # frozen batches keep their pool untouched
    keep = state.done[:, None]
    new_fin_scores = torch.where(keep, state.fin_scores, top_scores)
    new_fin_seqs = torch.where(keep[..., None], state.fin_seqs, new_fin_seqs)
    new_fin_lens = torch.where(keep, state.fin_lens, new_fin_lens)
    new_fin_count = torch.where(state.done, state.fin_count, new_fin_count)

    # ---- next beams: the first K non-EOS candidates in sorted order
    open_scores = torch.where(is_eos, NEG, cand_scores)
    k_scores, k_idx = stable_top_k(open_scores, K)                   # [B, K]
    k_token = token.gather(1, k_idx)
    k_origin = origin.gather(1, k_idx)
    # constraint boost AFTER selection (:1943-1944)
    boosted = ctx.cmask.gather(1, k_token)
    k_scores = torch.where(boosted, k_scores * ctx.constraint_factor, k_scores)

    # reorder sequences + append the token (frozen batches: no-op)
    new_seqs = state.seqs.gather(1, k_origin[..., None].expand(B, K, L_total))
    new_seqs[:, :, t] = k_token
    new_seqs = torch.where(keep[..., None], state.seqs, new_seqs)
    new_scores = torch.where(keep, state.beam_scores, k_scores)

    # reorder the KV cache by beam origin (global row ids)
    rows = (torch.arange(B, device=dev)[:, None] * K + k_origin).reshape(N)
    new_cache = KVCache(state.cache.k[:, rows], state.cache.v[:, rows])

    # done test (is_done, early_stopping=False, :1826-1839)
    cur_score = cand_scores[:, 0] / hyp_len[:, 0] ** ctx.length_penalty
    worst_kept = new_fin_scores.amin(dim=1)
    newly_done = (new_fin_count >= K) & (worst_kept >= cur_score)

    return BeamState(seqs=new_seqs, beam_scores=new_scores, cache=new_cache, cur_len=t + 1,
                     fin_seqs=new_fin_seqs, fin_scores=new_fin_scores, fin_count=new_fin_count,
                     done=state.done | newly_done, fin_lens=new_fin_lens)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, JAX's formula: ``-log(-log(u))`` with ``u``
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


@torch.no_grad()
def constrained_beam_sample(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,           # [B, Lp] right-padded
    prompt_len: torch.Tensor,           # [B]
    *,
    memory: Optional[torch.Tensor] = None,        # [B, M, D] fp32
    memory_mask: Optional[torch.Tensor] = None,   # [B, M]
    num_beams: int = 5,
    max_steps: int = 50,
    eos_id: int,
    pad_id: int = 0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,         # [max_steps, B, K·V] replayed draws
    constraint_mask: Optional[torch.Tensor] = None,  # [B, V] bool: add_score_ids
    constraint_factor: float = 0.8,
    repetition_penalty: float = 1.0,
    top_k: int = 50,
    length_penalty: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (best_tokens [B, max_steps], best_len [B]).  Step ``t`` draws
    its noise from ``generator`` (on the tokens' device), or takes
    ``noise[t]`` when ``noise`` is given."""
    if generator is None and noise is None:
        raise ValueError("constrained_beam_sample needs a torch.Generator or the noise")
    B, Lp = prompt_ids.shape
    K = num_beams
    V = decoder.config.vocab_size
    L_total = Lp + max_steps
    N = B * K
    dev = prompt_ids.device
    prompt_len = prompt_len.to(dev, torch.long)

    # --- expand the prompt over beams and prefill the cache; the memory's
    # cross K/V once per question
    p_ids = prompt_ids.long().repeat_interleave(K, dim=0)
    p_len = prompt_len.repeat_interleave(K, dim=0)
    cross = None
    if memory is not None and decoder.config.add_cross_attention:
        cross = decoder.cross_kv(memory)
    cache = KVCache.zeros(decoder.config, N, L_total, dev)
    pos = torch.arange(L_total, device=dev)[None, :]
    cache_valid = ((pos < p_len[:, None]) | (pos >= Lp)).float()
    logits, cache = decoder(p_ids, memory_mask=memory_mask, cross_kv=cross, cache=cache,
                            cache_index=0, cache_valid=cache_valid)
    last_logits = logits[torch.arange(N, device=dev), p_len - 1]       # [N, V]

    state = BeamState(
        seqs=torch.full((B, K, L_total), pad_id, dtype=torch.long, device=dev),
        beam_scores=torch.zeros((B, K), device=dev),
        cache=cache,
        cur_len=0,
        fin_seqs=torch.full((B, K, L_total), pad_id, dtype=torch.long, device=dev),
        fin_scores=torch.full((B, K), NEG, device=dev),
        fin_count=torch.zeros(B, dtype=torch.long, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        fin_lens=torch.zeros((B, K), dtype=torch.long, device=dev),
    )
    cmask = (constraint_mask.to(dev, torch.bool) if constraint_mask is not None
             else torch.zeros((B, V), dtype=torch.bool, device=dev))
    # the repetition penalty covers the PROMPT too (v10.py:2255)
    prompt_valid = torch.arange(Lp, device=dev)[None, :] < p_len[:, None]
    ctx = BeamContext(p_ids=p_ids, prompt_valid=prompt_valid, prompt_len=prompt_len,
                      cmask=cmask, eos_id=eos_id, num_beams=K,
                      constraint_factor=constraint_factor,
                      repetition_penalty=repetition_penalty, top_k=top_k,
                      length_penalty=length_penalty)

    def select(state: BeamState, logits: torch.Tensor) -> BeamState:
        t = state.cur_len
        g = (noise[t].to(dev) if noise is not None
             else gumbel_noise((B, K * V), generator, dev))
        return beam_select_step(state, F.log_softmax(logits.float(), dim=-1), ctx, g)

    # the first advance uses the prefill logits; then while_loop's condition,
    # read on the host once per step
    state = select(state, last_logits)
    while state.cur_len < max_steps and not bool(state.done.all()):
        t = state.cur_len
        tok = state.seqs.reshape(N, L_total)[:, t - 1]                  # last token
        logits, cache = decoder(tok[:, None], position_offset=p_len + t - 1,
                                memory_mask=memory_mask, cross_kv=cross, cache=state.cache,
                                cache_index=Lp + t - 1, cache_valid=cache_valid)
        state = select(state._replace(cache=cache), logits[:, 0])

    # ---- finalize: open beams fill remaining pool slots (scorer.finalize,
    # v10.py:1975+), scored at the prompt-inclusive length
    final_len = torch.clamp(prompt_len.float() + float(state.cur_len), min=1.0)[:, None]
    final_open = state.beam_scores / final_len ** length_penalty
    pool_scores = torch.cat([state.fin_scores, final_open], dim=1)
    pool_seqs = torch.cat([state.fin_seqs, state.seqs], dim=1)
    pool_lens = torch.cat([state.fin_lens, torch.full_like(state.fin_lens, state.cur_len)], dim=1)
    best = pool_scores.argmax(dim=1)                                  # first max, as JAX
    rows = torch.arange(B, device=dev)
    best_tokens = pool_seqs[rows, best][:, :max_steps]
    lengths = torch.clamp(pool_lens[rows, best], max=max_steps)
    return best_tokens, lengths
