"""FSM-constrained beam search (port of the JAX package's
``generation/fsm.py``; the utils/cbs.py capability of the reference).

Beam search over a finite-state-machine lattice ("Guided Open Vocabulary
Image Captioning with Constrained Beam Search"):

- :class:`FiniteStateMachineBuilder` — host-side numpy construction of the
  per-example adjacency tensor, a copy of the JAX package's (the
  reference's state layout and wiring, utils/cbs.py:631-857, including the
  quirk that a later single-word constraint's ``_connect`` RESTORES
  self-loops an earlier constraint removed, which makes the machine
  nondeterministic; the adjacency representation handles that).  It takes
  token ids; wordforms are lists of interchangeable ids.

- :func:`fsm_beam_search` — the search core (utils/cbs.py:54-364): one
  Python loop over the timesteps, each advancing a ``[B, S, K]`` lattice of
  beams by a top-K per target state and reordering the sequence buffer and
  the caller's decode carry (KV cache) by the backpointers.  The JAX
  function has two implementations of that loop (``lax.scan`` and an
  unrolled one) that give identical tokens (tests/test_fsm.py); the port
  has one.  Selection equals the reference's per-node-topk-then-global-topk
  for the default ``per_node_beam_size == beam_size``.

- :func:`select_best_beam_with_constraints` — length-normalized best-beam
  pick over constraint-satisfying main states (utils/cbs.py:366-431).

Ties are everywhere in a lattice (-inf and -1e20 fill most of each row; a
uniform language model ties every token), and ``lax.top_k`` keeps the lower
index first.  Every top-K here is :func:`generation.beam.stable_top_k`, the
first K of a stable descending sort, so the port picks what JAX picks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_context_reasoning_torch.generation.beam import stable_top_k
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder, KVCache

NEG = -1e20


class FSM(NamedTuple):
    """One example's finite state machine.

    ``adjacency[s_from, s_to, v] = 1`` ⇔ decoding token ``v`` in ``s_from``
    may move to ``s_to`` (utils/cbs.py:648-652 representation).
    """

    adjacency: np.ndarray       # [S, S, V] uint8
    num_main_states: int        # 2 ** max_given_constraints
    substate_end: int           # first unused sub-state index


class FiniteStateMachineBuilder:
    """Builds per-example FSMs from tokenized constraints.

    ``constraints`` for :meth:`build` is a list (≤ ``max_given_constraints``)
    of constraints; each constraint is a list of words (multi-word classes
    like "fire hydrant"); each word is a list of interchangeable token ids
    (wordforms — singular/plural etc.).
    """

    def __init__(
        self,
        vocab_size: int,
        max_given_constraints: int = 3,
        max_words_per_constraint: int = 3,
    ):
        self.vocab_size = vocab_size
        self.max_given_constraints = max_given_constraints
        self.max_words_per_constraint = max_words_per_constraint
        self.num_main_states = 2 ** max_given_constraints
        self.num_total_states = self.num_main_states * max_words_per_constraint

    def build(self, constraints: Sequence[Sequence[Sequence[int]]]) -> FSM:
        assert len(constraints) <= self.max_given_constraints
        S, V = self.num_total_states, self.vocab_size
        fsm = np.zeros((S, S, V), np.uint8)
        # self-loops for all words on main states (cbs.py:736-739)
        for s in range(self.num_main_states):
            fsm[s, s, :] = 1

        substate_idx = self.num_main_states
        for n, constraint in enumerate(constraints, start=1):
            words = list(constraint)[: self.max_words_per_constraint]
            substate_idx = self._add_nth_constraint(fsm, n, substate_idx, words)
        return FSM(fsm, self.num_main_states, substate_idx)

    def _add_nth_constraint(self, fsm, n: int, substate_idx: int,
                            words: Sequence[Sequence[int]]) -> int:
        """cbs.py:749-807: connect every main state whose bit ``n-1`` is
        unset to its partner with the bit set, via sub-states for
        multi-word constraints."""
        stride = 2 ** (n - 1)
        from_state = 0
        while from_state < self.num_main_states:
            for _ in range(stride):
                word_from = from_state
                for i, wordforms in enumerate(words):
                    if i != len(words) - 1:
                        self._connect(fsm, word_from, substate_idx,
                                      wordforms, reset_state=from_state)
                        word_from = substate_idx
                        substate_idx += 1
                    else:
                        self._connect(fsm, word_from, from_state + stride,
                                      wordforms, reset_state=from_state)
                from_state += 1
            from_state += stride
        return substate_idx

    @staticmethod
    def _connect(fsm, from_state: int, to_state: int,
                 wordform_ids: Sequence[int], reset_state: int) -> None:
        """cbs.py:809-857 including its reset quirk: the reset block runs
        unconditionally (the reference always passes ``reset_state``), so a
        single-word constraint's origin row gets its self-loops REWRITTEN —
        restoring self-loops earlier constraints removed and leaving both
        transitions live (a nondeterministic edge the lattice search
        handles; removing this line would "fix" the reference's behavior,
        which parity forbids)."""
        for w in wordform_ids:
            fsm[from_state, to_state, w] = 1
            fsm[from_state, from_state, w] = 0
        # reset for non-matching words (sub-states), or the quirky self-loop
        # rewrite (main states, where reset_state == from_state)
        fsm[from_state, from_state, :] = 0
        fsm[from_state, reset_state, :] = 1
        for w in wordform_ids:
            fsm[from_state, reset_state, w] = 0



def fsm_beam_search(
    init_logp: torch.Tensor,                # [B, V] first-step log-probs
    step_fn: Callable,                      # (tok [N], carry, t) -> (logp [N, V], carry)
    carry,                                  # decode state over N = B*S*K rows
    reorder_fn: Callable,                   # (carry, rows [N]) -> carry
    adjacency: torch.Tensor,                # [B, S, S, V] {0,1}
    *,
    num_beams: int,
    max_steps: int,
    eos_ids: Sequence[int],
    pad_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (beams [B, S, K, max_steps], log_probs [B, S, K]).

    Faithful to ConstrainedBeamSearch.search (utils/cbs.py:54-364,
    ``use_hypo=False``): ``max_steps - 1`` tokens are decoded and the tail is
    padded with ``eos_ids[0]``; finished rows continue with probability-1
    EOS (log_probs_after_end, :153-156), which also reproduces the
    reference's early-break-then-pad behavior.

    One loop over the timesteps, as the JAX function's ``unrolled`` form;
    each step ranks the candidates of one question at a time (its
    ``[S_to, S_from·K·V]`` score plane is the largest temporary).
    """
    B, S, _, V = adjacency.shape
    K = num_beams
    N = B * S * K
    eos_ids = tuple(eos_ids)
    pad_tok = eos_ids[0] if pad_id is None else pad_id
    n_steps = max_steps - 1
    dev = init_logp.device

    adjacency = adjacency.to(dev, torch.bool)
    eos_arr = torch.tensor(eos_ids, device=dev)
    after_end = torch.full((V,), -torch.inf, device=dev)
    after_end[eos_arr] = 0.0
    # [B, S_to, S_from, V]: the lattice viewed from the target state, so one
    # top-K per row serves all S states at once
    adj_t = adjacency.transpose(1, 2)

    # ---- first step: from state 0 only (cbs.py:134-151)
    seqs = torch.full((B, S, K, n_steps), pad_tok, dtype=torch.long, device=dev)
    start = torch.where(adjacency[:, 0], init_logp.float()[:, None, :], -torch.inf)
    last_logp, tok0 = stable_top_k(start, K)                   # [B, S, K]
    seqs[..., 0] = tok0
    rows_base = torch.arange(B, device=dev)[:, None] * (S * K)

    for t in range(1, n_steps):
        last_tok = seqs[..., t - 1].reshape(N)
        logp, carry = step_fn(last_tok, carry, t)
        finished = torch.isin(last_tok, eos_arr)
        cleaned = torch.where(finished[:, None], after_end, logp.float()).reshape(B, S, K, V)

        # mask BEFORE adding running scores (cbs.py:221-225)
        new_logp, idx = [], []
        for b in range(B):
            scores = torch.where(adj_t[b, :, :, None, :], cleaned[b][None], NEG)
            scores += last_logp[b][None, :, :, None]
            lp_b, idx_b = stable_top_k(scores.reshape(S, S * K * V), K)   # [S, K]
            new_logp.append(lp_b)
            idx.append(idx_b)
            del scores
        last_logp, idx = torch.stack(new_logp), torch.stack(idx)
        new_tok = idx % V
        backptr = (idx // V).reshape(B, S * K)                 # flat (s*K+k)

        # reorder sequences by backpointer, append the new token
        seqs = seqs.reshape(B, S * K, n_steps).gather(
            1, backptr[..., None].expand(B, S * K, n_steps)).reshape(B, S, K, n_steps)
        seqs[..., t] = new_tok
        # reorder the caller's decode carry (KV cache) by global row ids
        carry = reorder_fn(carry, (rows_base + backptr).reshape(N))

    beams = torch.cat([seqs, torch.full((B, S, K, max_steps - n_steps), eos_ids[0],
                                        dtype=torch.long, device=dev)], dim=-1)
    return beams, last_logp


def select_best_beam_with_constraints(
    beams: torch.Tensor,                  # [B, S, K, T]
    beam_log_probabilities: torch.Tensor,  # [B, S, K]
    given_constraints: torch.Tensor,      # [B] int
    min_constraints_to_satisfy: int,
    eos_ids: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cbs.py:366-431, vectorized: among MAIN states reachable under the
    given constraint count whose popcount meets the requirement, pick the
    top beam with the highest length-normalized log-probability (the first
    such state on a tie, as ``jnp.argmax``)."""
    B, S, K, T = beams.shape
    dev = beams.device
    states = torch.arange(S, device=dev)
    pop = ((states[:, None] >> torch.arange(16, device=dev)) & 1).sum(dim=-1)   # [S]
    given = torch.as_tensor(given_constraints, device=dev).long()
    need = torch.clamp(given, max=min_constraints_to_satisfy)                  # [B]
    valid = ((states[None, :] < (torch.ones_like(given) << given)[:, None])   # reachable
             & (pop[None, :] >= need[:, None]))                                # [B, S]

    top = beams[:, :, 0, :]                                    # [B, S, T]
    notend = torch.ones((B, S, T), dtype=torch.long, device=dev)
    for e in eos_ids:
        notend = notend * (top != e).long()
    length = notend.sum(dim=-1) + 1                            # [B, S]
    norm_lp = beam_log_probabilities[:, :, 0] / length
    norm_lp = torch.where(valid, norm_lp, -torch.inf)
    best_state = norm_lp.argmax(dim=-1)                        # [B]
    rows = torch.arange(B, device=dev)
    return top[rows, best_state], norm_lp[rows, best_state]


@torch.no_grad()
def fsm_decode_gpt2(
    decoder: GPT2Decoder,
    prompt_ids: torch.Tensor,            # [B, Lp] right-padded
    prompt_len: torch.Tensor,            # [B]
    adjacency: torch.Tensor,             # [B, S, S, V]
    *,
    memory: Optional[torch.Tensor] = None,
    memory_mask: Optional[torch.Tensor] = None,
    num_beams: int = 5,
    max_steps: int = 20,
    eos_ids: Sequence[int] = (50256,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FSM-constrained decoding with the port's KV-cached GPT-2: the prompt
    is prefilled once over B·S·K expanded rows, then :func:`fsm_beam_search`
    drives single-token cached steps, reordering the cache by lattice
    backpointers each step.  The memory's cross-attention keys and values
    are projected once per question and shared by its S·K rows
    (models/gpt2.py)."""
    B, Lp = prompt_ids.shape
    S = adjacency.shape[1]
    K = num_beams
    N = B * S * K
    L_total = Lp + max_steps
    dev = prompt_ids.device

    p_ids = prompt_ids.long().repeat_interleave(S * K, dim=0)
    p_len = prompt_len.to(dev, torch.long).repeat_interleave(S * K, dim=0)
    cross = None
    if memory is not None and decoder.config.add_cross_attention:
        cross = decoder.cross_kv(memory)
    cache = decoder.new_cache(N, L_total, dev)
    pos = torch.arange(L_total, device=dev)[None, :]
    cache_valid = ((pos < p_len[:, None]) | (pos >= Lp)).float()
    logits, cache = decoder(p_ids, memory_mask=memory_mask, cross_kv=cross, cache=cache,
                            cache_index=0, cache_valid=cache_valid)
    last = logits[torch.arange(N, device=dev), p_len - 1]
    init_logp = F.log_softmax(last.reshape(B, S * K, -1)[:, 0].float(), dim=-1)

    def step_fn(tok, cache, t):
        logits, cache = decoder(tok[:, None], position_offset=p_len + t - 1,
                                memory_mask=memory_mask, cross_kv=cross, cache=cache,
                                cache_index=Lp + t - 1, cache_valid=cache_valid)
        return F.log_softmax(logits[:, 0].float(), dim=-1), cache

    def reorder_fn(cache, rows):
        return KVCache(cache.k[:, rows], cache.v[:, rows])

    return fsm_beam_search(init_logp, step_fn, cache, reorder_fn, adjacency,
                           num_beams=K, max_steps=max_steps, eos_ids=eos_ids)
