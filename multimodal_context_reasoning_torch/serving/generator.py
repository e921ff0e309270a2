"""Online rationale generation: classify the candidates, then decode an
explanation (port of the JAX package's ``serving/generator.py``).

It serves the rationale family (``ChunkAlign_CLS_dec5_4``) as
:class:`ModCRScorer` serves the production classifier.  Each micro-batch of
questions is

1. one :class:`RationaleModel` forward over the questions' candidate rows:
   choice probabilities and the decoder memory of each question's gold row,
   where "gold" is the model's own argmax;
2. one KV-cached decode (generation/api.py) over that memory, prompted with
   ``<|b_rtnl|>`` and stopped at ``<|e_rtnl|>``, the markers of the
   reference's explanation streams.

The two run back to back on the device with no read back to the host between
them (the JAX package traces them as one program for that reason); the
results are read once at the end.  The generator runs on the GPU unless the
caller passes ``device="cpu"``; asking for CUDA where there is none raises.
Its encoders and heads hold their weights in the encoder config's compute
dtype (cast once, as the scorer does), the decoder in fp32.

``mesh`` runs it in SPMD style, as ``ModCRScorer(mesh=)``: every rank
classifies and decodes its data index's questions of each micro-batch
through its shard of the model and returns the whole result.  Sampling
draws each rank's questions from the generator it is given.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import (
    ChunkAlignConfig,
    EncoderConfig,
    GPT2Config,
)
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.collate import BatchSpec, collate_candidates
from multimodal_context_reasoning_torch.data.rationale import B_RTNL, E_RTNL
from multimodal_context_reasoning_torch.data.schemas import RawExample
from multimodal_context_reasoning_torch.data.vcr import VCRDataset
from multimodal_context_reasoning_torch.generation.api import generate
from multimodal_context_reasoning_torch.models.rationale import RationaleModel
from multimodal_context_reasoning_torch.parallel.comm import gather_rows
from multimodal_context_reasoning_torch.parallel.mesh import axis_group, axis_index
from multimodal_context_reasoning_torch.parallel.partition import local_rows
from multimodal_context_reasoning_torch.serving.scorer import (
    pad_by_repetition,
    run_chunked,
    shard_for_serving,
)

# the collated arrays the classify forward reads
MODEL_KEYS = ("input_ids", "token_type_ids", "text_mask", "gather_index", "img_feat",
              "img_mask")


def classify_batch(feats: Sequence, spec: BatchSpec,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Collate a full micro-batch of ``featurize`` outputs and move the
    arrays the classify forward reads to ``device``."""
    batch = collate_candidates([f[0] for f in feats], [f[1] for f in feats], spec)
    return {k: torch.from_numpy(batch[k]).to(device) for k in MODEL_KEYS}


def greedy_prompt(b_rtnl: int, questions: int, device: torch.device):
    """(prompt [Q, 1] of ``<|b_rtnl|>``, prompt lengths [Q] of 1)."""
    return (torch.full((questions, 1), b_rtnl, dtype=torch.long, device=device),
            torch.ones(questions, dtype=torch.long, device=device))


def decode_ids(tokenizer, ids: Sequence[int]) -> Optional[str]:
    """Best-effort id -> text: a HuggingFace adapter exposes its tokenizer's
    ``decode``; hash tokenizers are one-way (ids only)."""
    hf = getattr(tokenizer, "_tok", None)
    if hf is not None and hasattr(hf, "decode"):
        return hf.decode(list(ids), skip_special_tokens=False)
    return None


def format_generate_results(
    probs, tokens, lengths, real: int, example_ids: Sequence[str],
    *, e_rtnl: int, gpt_tokenizer,
) -> List[Dict]:
    """Decoder outputs -> /generate response rows."""
    probs = np.asarray(probs, np.float32)[:real]
    tokens = np.asarray(tokens)[:real]
    lengths = np.asarray(lengths)[:real]
    results = []
    for eid, pr, tok, ln in zip(example_ids, probs, tokens, lengths):
        ids = [int(t) for t in tok[: int(ln)]]
        if ids and ids[-1] == e_rtnl:
            ids = ids[:-1]  # the stop marker is an internal sentinel
        res = {
            "example_id": eid,
            "prediction": int(np.argmax(pr)),
            # per-candidate P(true): independent binary heads, not a softmax
            "probs": [float(x) for x in pr],
            "rationale_ids": ids,
        }
        text = decode_ids(gpt_tokenizer, ids)
        if text is not None:
            res["rationale_text"] = text
        results.append(res)
    return results


class RationaleGenerator:
    """``weights`` is a :class:`RationaleModel` (moved and cast in place) or
    a state dict in its layout (``interop/from_jax.py``, or a reference
    checkpoint through ``interop/assemble.py``)."""

    def __init__(
        self,
        encoder_config: EncoderConfig,
        schedule: ChunkAlignConfig,
        gpt2_config: GPT2Config,
        weights: Union[RationaleModel, Mapping[str, torch.Tensor]],
        bert_tokenizer,
        gpt_tokenizer,
        image_features,                  # mapping img_id -> ImageFeatures
        *,
        spec: Optional[BatchSpec] = None,
        num_labels: int = 4,
        cls_layer_num: int = 3,
        max_chunks: int = 40,
        micro_batch: int = 1,            # questions per forward
        max_rationale_len: int = 32,
        mode: str = "greedy",            # greedy | sample
        warm: bool = True,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        b_id, e_id = gpt_tokenizer.convert_tokens_to_ids([B_RTNL, E_RTNL])
        self.b_rtnl, self.e_rtnl = int(b_id), int(e_id)
        # an id past the vocabulary raises on the CPU and trips a device-side
        # assert on the card, which ends the CUDA context; identical ids
        # mean the tokenizer mapped both markers to unk
        V = gpt2_config.vocab_size
        if not (0 <= self.b_rtnl < V and 0 <= self.e_rtnl < V):
            raise ValueError(
                f"rationale marker ids ({self.b_rtnl}, {self.e_rtnl}) fall outside "
                f"GPT2Config.vocab_size={V} — size the config to the tokenizer "
                "(len(tokenizer)) or the checkpoint's dec.wte rows")
        if self.b_rtnl == self.e_rtnl:
            raise ValueError(
                f"{B_RTNL}/{E_RTNL} map to the same id {self.b_rtnl} — the GPT "
                "tokenizer lacks the rationale marker tokens (both collapsed to unk); "
                "add them as special tokens")
        if 1 + max_rationale_len > gpt2_config.n_positions:
            raise ValueError(f"max_rationale_len={max_rationale_len} needs "
                             f"{1 + max_rationale_len} positions > n_positions="
                             f"{gpt2_config.n_positions}")

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if isinstance(weights, nn.Module):
            model = weights.to(self.device)
        else:
            model = RationaleModel(encoder_config, schedule, gpt2_config,
                                   num_labels=num_labels, cls_layer_num=cls_layer_num,
                                   max_chunks=max_chunks, device=self.device)
            model.load_state_dict(weights, strict=True)
        model = model.cast_classifier_()
        if mesh is not None:
            # decode arrays are per question, so the questions themselves
            # split over the data axis
            shard_for_serving(model, mesh, micro_batch, "questions")
        self.mesh = mesh
        self.model = model.eval()
        self.encoder_config = encoder_config
        self.micro_batch = micro_batch
        self.max_rationale_len = max_rationale_len
        self.mode = mode
        self.num_labels = num_labels
        self.gpt_tokenizer = gpt_tokenizer
        self.features = image_features
        self.gpt2_config = gpt2_config
        self._auto_seed = itertools.count()   # sample mode without a generator
        self.spec = spec or BatchSpec(num_labels=num_labels)
        # the rationale family is VCR-native: the VCR featurizer carries its
        # answer-truncation heuristic
        self._ds = VCRDataset([], image_features, bert_tokenizer, gpt_tokenizer,
                              spec=self.spec, max_chunks=max_chunks)
        if warm:
            self.warm_up()

    def warm_up(self) -> None:
        """Generate for one question of the first image: on the card the
        first forward builds and loads the kernels."""
        self.generate([RawExample(
            example_id="warm", img_id=next(iter(self.features.keys())),
            premise="warm up .", answer_choices=["a ."] * self.num_labels, answer_label=0,
        )])

    def _seeded(self, generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """Sampling without a generator draws from a fresh one seeded by an
        instance counter, so repeated requests get different samples."""
        if self.mode == "greedy" or generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(next(self._auto_seed))

    def generate(self, examples: Sequence[RawExample], *,
                 generator: Optional[torch.Generator] = None) -> List[Dict]:
        """Classify and decode any number of questions, chunked to the
        micro-batch (the last chunk padded by repetition); in sample mode
        the chunks of one call draw from one generator in turn."""
        return run_chunked(self, examples, generator=self._seeded(generator))

    def featurize(self, ex: RawExample):
        """Host-side featurization of one question (numpy only); the
        ``MicroBatcher`` protocol, as ``ModCRScorer.featurize``."""
        return self._ds.featurize(ex), self._ds.get_image(ex)

    def device_batch(self, feats: Sequence) -> Dict[str, torch.Tensor]:
        """Collate a full micro-batch of :meth:`featurize` outputs and move
        the arrays the classify forward reads to the generator's device."""
        return classify_batch(feats, self.spec, self.device)

    def decode(self, out, *, generator: Optional[torch.Generator] = None):
        """(tokens, lengths) of the generator's mode over a classify
        forward's decoder memory, prompted with ``<|b_rtnl|>``."""
        prompt, prompt_len = greedy_prompt(self.b_rtnl, out.decoder_memory.shape[0],
                                           self.device)
        return generate(
            self.model.dec, prompt, prompt_len, mode=self.mode,
            memory=out.decoder_memory.float(), memory_mask=out.decoder_memory_mask,
            max_len=self.max_rationale_len, eos_id=self.e_rtnl,
            pad_id=self.gpt2_config.pad_token_id, generator=generator)

    def score_featurized(self, feats: Sequence, example_ids: Sequence[str], *,
                         generator: Optional[torch.Generator] = None) -> List[Dict]:
        """One classify forward and one decode over up to micro_batch
        featurized questions (the ``MicroBatcher`` entry point)."""
        if not feats:
            return []
        generator = self._seeded(generator)
        real, feats = pad_by_repetition(feats, self.micro_batch)
        with torch.inference_mode():
            out = self.model(local_rows(self.device_batch(feats), self.mesh))
            tokens, lengths = self.decode(out, generator=generator)
            d, data = axis_index(self.mesh, "data"), axis_group(self.mesh, "data")
            probs = gather_rows(out.mp_probs, d, data)
            tokens, lengths = gather_rows(tokens, d, data), gather_rows(lengths, d, data)
        return format_generate_results(
            probs.cpu().numpy(), tokens.cpu().numpy(), lengths.cpu().numpy(), real,
            example_ids, e_rtnl=self.e_rtnl, gpt_tokenizer=self.gpt_tokenizer)
