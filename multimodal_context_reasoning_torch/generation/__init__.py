"""Rationale generation (port of the JAX package's ``generation/``): greedy
and sampled KV-cached decode, constrained beam sampling, attention-derived
lexical constraints, the box-driven constraint front end and FSM-constrained
beam search, behind ``generation/api.py::generate``."""

from multimodal_context_reasoning_torch.generation.decode import (  # noqa: F401
    greedy_decode,
)
from multimodal_context_reasoning_torch.generation.beam import (  # noqa: F401
    constrained_beam_sample,
)
from multimodal_context_reasoning_torch.generation.box_constraints import (  # noqa: F401
    ClassHierarchy,
    ConstraintBoxesReader,
    ConstraintFilter,
    boxes_to_constraint_ids,
    load_wordforms,
    tokenize_constraints,
)
from multimodal_context_reasoning_torch.generation.constraints import (  # noqa: F401
    extract_constraints,
)
from multimodal_context_reasoning_torch.generation.fsm import (  # noqa: F401
    FiniteStateMachineBuilder,
    fsm_beam_search,
    fsm_decode_gpt2,
    select_best_beam_with_constraints,
)
