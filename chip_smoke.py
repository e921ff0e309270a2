"""GPU smoke run of the PyTorch port: build, check and time its three CUDA
kernels, serve full-width PMR scoring, train the PMR step at full width,
run the two commands (``cli/run_pmr.py``, ``cli/run_vcr.py``) at full width,
hold every kernel route to its plain version past 192 keys, serve
concurrent HTTP clients through the serve command (``cli/serve.py``),
score through the W8A8 int8 route, serve the rationale family at
``POST /generate``, decode it by beam sampling and CBS, train it, run
the two-stage recipe (``cli/train_two_stage.py``), run the ensemble
and CLIP ablations with the CLIP precompute command
(``cli/precompute_clip.py``), and hold the kernels' dispatcher ops, the
device-resident feature table, the AOT artifacts (``serving/aot.py``) and
the profiled, logged trainer (phase 21), and scale the train step and the
scorer out over ``torch.distributed`` (phase 22).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero (printing no result) without one, when
the port is not beside this script, or when any phase fails.  Phases:

1. device: card name, power limit, TF32 off;
2. build: ``nvcc`` builds ``csrc/{spec_attention,fused_attention,flash_bwd}.cu``
   (the first two share ``csrc/attention_mma.cuh``) from this checkout, one
   process per source, all started together, and prints each kernel's
   registers and spill bytes as ``ptxas -v`` gives them (the bf16 forwards
   once per instance: keys / 16 and mask functor);
3. kernel vs plain: the stage-mask kernel against its plain PyTorch version
   at the five ModCR shapes of each served micro-batch (8 and 32), fp32
   (1e-4 abs, the FP32-pipe route) and bf16 (2e-2 abs, the tensor-core
   route), plus fully masked rows, and two bf16 launches bit-equal;
4. timing: kernel, plain version and ``F.scaled_dot_product_attention`` with
   the same mask as a dense boolean (the yardstick only; the port never
   calls it), bf16 at the micro-batch-8 shapes, CUDA events, median of 25
   calls each in its own window; then the kernel and SDPA as 25 launches
   back to back in one window, divided by 25 (median of 5 windows); each
   summed over one forward's 60 launches; 4b: the kernel, plain version
   and SDPA per call and back to back at the frozen encoders' shapes of a
   32-example training step, (128, 190, 190, 12, 64) in the full and chunk
   stages and (32, 51, 51, 12, 64);
5. end-to-end parity: full-width fp32 ``ModCRConfig()`` scoring one example
   on the card (kernel) and on the CPU (plain version), same weights;
6. serving: full-width bf16 ``ModCRScorer`` at micro-batch 8 and 32; every
   forward must launch the stage-mask kernel exactly 60 times;
7. training kernels vs plain, at the RoBERTa training shape (128 rows,
   Lq 128, Lk 138, 16 heads, Dh 64), fp32 and bf16, ragged padding: the
   dense-bias forward (tolerances as phase 3; bf16 on the tensor-core
   kernel, also at Lq = Lk = 190 with the chunk stage's [B, 1, Lq, Lk] mask
   plane as bias, 2e-2 of max |plain|); the backward's dq, dk, dv and
   dbias plane with a random dO (1e-4 of each output's max |plain| in fp32:
   atomics and summation order; 2e-2 in bf16: P and dS are rounded before
   their products); the stage-mask op's gradients against autograd of
   its plain version in the full stage at that shape and in the chunk stage
   at (32, 190, 190, 12, 64); a fully masked row; the bf16 backward at
   Lq = Lk = 190 with the chunk stage's [B, 1, Lq, Lk] mask plane as bias,
   and two bf16 launches at the training shape bit-equal in dq, dk, dv;
8. training kernel timing, bf16 at that shape: kernel, plain version and
   SDPA with the float bias as ``attn_mask`` (forward) or SDPA's backward
   through autograd (backward), CUDA events, median of 25 calls each in its
   own event window (the wrapper's host time included), and each kernel's
   share of its bound; then the kernel and SDPA again as 25 launches back
   to back in one window, divided by 25 (the median of 5 such windows);
9. training parity: full-width fp32 ``ModCRConfig()`` with dropout 0, one
   example (4 rows), two ``train_step``s on the card (kernels) and on the CPU
   (plain versions) from one state dict, ``remat=False`` (the stage-mask
   forward and the backward kernel): losses and gradient norms to 1e-4
   relative;
10. training (the slice's main path): the production geometry in bf16 with
    dropout 0, RoBERTa remat "full", 32 examples (128 rows) per step, 8 steps
    through ``Trainer.fit`` with validation every 4 steps and a best-accuracy
    checkpoint in a temporary directory; every train step launches exactly
    36 stage-mask, 48 dense-forward and 24 backward kernels;
11. the ``kernels`` JSON line (each kernel's ``launches`` from phase 10's
    run, ``cli_launches`` from phase 12's, ``serve_launches`` from phase
    14's, ``long_keys`` from phase 13, the stage-mask kernel's
    ``int8_launches``, ``generate_launches`` and ``beam_cbs_launches`` from
    phases 15-17, ``rationale_train_launches`` of both kernels from phase
    18, ``stage1_launches`` and ``two_stage_launches`` of all three from
    phase 19, the backward's ``encoder_shapes`` from 18b and 19c, the
    stage-mask forward's from 19c, ``ensemble_launches`` of all three from
    phase 20b and each kernel's ``roberta_no_prefix`` rows from 20e,
    ``aot_launches``, ``device_table_launches`` and ``op_host_us`` from
    phase 21, ``parallel_launches`` per mesh from phase 22b's rank 0), then
    the result line; the summary line before it carries ``ensembles``,
    ``clip``, ``standalone`` (phase 21) and ``parallel`` (phase 22);
12. (run before 11) the two commands through ``main(argv)``, full-width
    bf16, on files written from the seed in a temporary directory (PMR
    JSONL of 64 / 32 / 32 examples, a VCR JSON of 64, 50 x 2054 region
    features per image as a pickle and an ``.mcrpack``): ``run_pmr
    --do_train`` at the reference defaults otherwise (16 examples a step, 4
    steps, validation every 2; dropout 0.1 in RoBERTa, so a train step
    launches no kernel), checking finite losses, ``config.json`` and a best
    checkpoint; ``run_pmr --do_test`` from that checkpoint on the
    ``.mcrpack``, checking one prediction per example; ``run_vcr --do_train``
    for 2 steps of 4 micro-batches, checking that the RoBERTa body is
    bit-unchanged and its embeddings and the mapping networks trained; and
    ``run_pmr --do_test --max_img_seq_length 100`` (random init, 100 regions
    an image: 240 encoder keys, the bf16 kernels' key-looped instances),
    checking one prediction per example.  Every validation and test forward
    must launch the stage-mask kernel exactly
    ``spec_launches_per_eval_forward`` (57) times;
13. (run before 11) long keys: the stage-mask forward (full, chunk, cross),
    the dense forward (row and plane bias) and the backward with dbias, fp32
    and bf16, against their plain versions at Lk 240 and 520 (32 rows, 12
    heads; tolerances as phases 3 and 7), fully masked rows, and two bf16
    launches bit-equal at 240; then bf16 kernel, plain version, SDPA and
    bound per call and back to back at (128, 240, 240, 12, 64) full and
    chunk stage and at (128, 230, 240, 16, 64) for the dense forward and
    the backward;
14. (run before 11) serving, the slice's main path: ``python -m
    multimodal_context_reasoning_torch.cli.serve`` as a subprocess on a free
    port (full width, bf16, micro-batch 8, seeded random init, an
    ``.mcrpack``), polled on ``/healthz``; 16 concurrent clients send 4
    requests each of 1-4 examples (after a warm-up round of 16 one-example
    requests); every reply must be 200 with finite logits within 2e-2 of
    max |logit| of direct ``ModCRScorer.score`` on the same weights, and the
    same prediction wherever the direct top two logits are more than twice
    that apart; examples/s, p50/p99 request latency and the mean dispatch
    size (``/stats``) are printed; the server must exit on SIGTERM.  The same
    load then runs in-process through ``serve(block=False)`` on the direct
    scorer with the kernel counts set to 0 before and read after: 57
    stage-mask launches per dispatched forward;
15. (run before 11) int8: ``int8_matmul`` against its plain version at the
    encoders' FFN product at micro-batch 8 (6,080 x 768 · 768 x 3,072) and
    RoBERTa's at 32 (16,384 x 1,024 · 1,024 x 4,096), int32 accumulators
    and bf16 outputs bit-equal, then the int8 route, ``torch._int_mm``
    alone and a bf16 ``F.linear`` back to back; the full-width bf16 scorer
    with and without ``with_quantize("int8")`` on one set of weights at
    micro-batch 8 and 32, in turns, with the counts set to 0 before each
    int8 run: exactly 60 stage-mask launches per forward, examples/s, max
    |Δlogit| and agreeing 4-way decisions; one /score request to ``cli.serve
    --quantize int8``, held against direct int8 scoring;
16. (run before 11) /generate: the rationale family at full width
    (``EncoderConfig()``, ``GPT2Config()``, seeded random init): one
    question in fp32 on the card and on the CPU (mp_probs within 1e-4, the
    decoder memory and the decoder's teacher-forced logits over the CPU's
    greedy tokens within 1e-3; token agreement printed); then bf16 encoders
    at 4 questions a forward and 32 decode steps, in-process
    ``serve(generator=...)`` with the counts set to 0 before and read after
    (exactly 24 stage-mask launches per classify forward) and ``cli.serve
    --generate`` in its own process, each under 8 clients x 2 requests of
    1-2 questions, every reply equal to direct ``RationaleGenerator.generate``
    (prediction and rationale ids, probabilities within 2e-2); questions/s,
    request latency, ms per decoder call, mean dispatch and peak memory;
    ``mode="sample"`` once: a fixed seed repeats and every token lies in the
    top-k/top-p kept set of its teacher-forced logits;
17. (run before 11) beam and CBS at full width (``EncoderConfig(dtype=
    "bfloat16")``, ``ChunkAlignConfig()``, fp32 ``GPT2Config()``, seeded
    random init, 4 questions), with the kernel counts set to 0 before the
    path and read after it: the classify forward (exactly 24 stage-mask
    launches, none in the decodes), ``cls_attn`` of each question's chosen
    row -> ``extract_constraints`` through the hash tokenizers ->
    ``generate(mode="beam", num_beams=5, max_len=32, top_k=50,
    constraint_mask=...)``; synthetic detections -> ``ConstraintFilter`` ->
    ``boxes_to_constraint_ids`` (3 constraints) -> the FSM (24 states) ->
    ``generate(mode="cbs", num_beams=5, max_len=20,
    min_constraints_to_satisfy=2)``, whose chosen beam must carry at least 2
    of its constraints; per mode ms per decode and per decoder call (CUDA
    events), questions/s, device kernels per decoder call (``torch.profiler``)
    and peak memory; 17a: fp32 card against CPU at a 2-layer full-width
    GPT-2: CBS tokens identical and lattice log-probs within 1e-4 +
    1e-5·|lp|, beam tokens and lengths identical with one replayed noise
    tensor and the chosen tokens' log-probs within the same bound;
18. (run before 11) rationale training at full width: ``Trainer.fit`` over
    ``RationaleForTraining`` (bf16 encoders from fp32 parameters, fp32
    GPT-2, encoders trainable, dropout 0), 8 questions (32 rows) a step, 6
    steps, every step launching exactly 24 stage-mask forwards and 24
    backwards; ms per step (median of steps 2-6), questions/s, peak memory;
    one more step with every backward launch held against
    ``flash_attention_bwd_plain`` on its own inputs (2e-2 of max |plain|);
    18a: two fp32 ``train_step``s card against CPU at 3-layer encoders and a
    2-layer GPT-2 (full widths): losses and gradient norms within 1e-4
    relative, parameters within 2 x steps x lr; 18b: the backward at
    (32, 190, 190, 12, 64) bf16 with each stage's mask as the stage-mask
    op's gradient passes it, against its plain version, then kernel, plain
    version and SDPA's backward per call and back to back, and the bound;
19. (run before 11) the two-stage recipe: 19a, two fp32 ``train_step``s of
    ``ChunkAlignClassifier`` at full width (schedule 3/9, dropout 0, one
    question) on the card and on the CPU from one state dict: the binary
    CE, the alignment CE and the gradient norms within 1e-4 relative; 19b,
    ``cli.train_two_stage.main(argv)`` at full width, bf16, dropout 0, on 96
    PMR rows written from the seed, 16 questions (64 rows) a step, 8
    stage-1 and 4 stage-2 steps, validation every 4: every stage-1 train
    step launches exactly 21 stage-mask forwards, no dense forward and 21
    backwards (``stage1_launches``), every stage-1 evaluation forward 21
    stage-mask launches, every stage-2 step 36 / 48 / 24 and every stage-2
    evaluation forward 36 stage-mask and 24 dense (RoBERTa under remat);
    finite losses, the export's keys, a graft with no leftover key and the
    curve's keys; device ms per step of each stage (CUDA events), peak
    memory per stage and the wall; 19c, one more stage-1 forward and
    backward after the last step, each backward launch held against its
    plain version's float64 error plus 2e-2, with dq's distance from
    float64 as a share of max |dq| for the kernel and the plain version;
    then the stage-mask forward and the backward on that pass's full-stage
    and chunk-stage inputs, (64, 190, 190, 12, 64) bf16: kernel, plain
    version and SDPA per call and back to back, and the bound;
20. (run before 11) the ensembles and CLIP: 20a, full-width fp32
    ``DualEnsembleModel`` (dropout 0, one question) on the card and on the
    CPU from one state dict, the RoBERTa view's logits, loss, alignment loss
    and each parameter group's gradient norm (45 stage-mask and 45 backward
    launches) and the GPT-2 view's forward (``gpt_pool="last_real"``, 21),
    then the CLIP ViT-B/16 towers on 2 images and 8 id rows, all within
    1e-4 relative; 20b, the slice's main path with the counts set to 0
    before it and read after: full-width bf16 evaluation forwards of 8
    questions (``fusion`` concat and add with the RoBERTa view, 45
    stage-mask launches each; the GPT-2 view, 21), the RoBERTa view's batch
    through ``PMRDataset``, the GPT-2 view's through ``VCRDataset(lm_style=
    "gpt")`` with a GPT-2 byte-BPE tokenizer, ms per forward (median of 10
    after 3), examples/s and peak memory beside ``ModCRModel``'s forward and
    phase 6's scorer; one forward and backward under
    ``pmr_training_config()`` (RoBERTa remat "full", encoders frozen) with
    exactly 21 stage-mask, 48 dense-forward and 24 backward launches, then
    one more (uncounted) with each dense-forward launch held against its
    plain version (2e-2 of max |plain|) and each backward launch against its
    plain version and both against float64 (as 18 and 19c); 20c,
    the ViT-B/16 towers in bf16 and fp32 on [32, 224, 224, 3] pixels and
    [128, 77] ids (ms per call, images/s), ``ClipEndToEnd`` with both
    variants, ``ClipGatedEnsemble`` over 20b's CALeC and RoBERTa vectors and
    the top-2 gate with tied scores against a numpy twin; 20d,
    ``cli.precompute_clip.main(argv)`` at full width on a random checkpoint
    in OpenAI's layout, 32 examples over 16 PNG images and a reduced merges
    table (the vocabulary, the one cut from ViT-B/16), both packs against
    direct tower calls (a side whose host package is absent is named and
    skipped); 20e, the three kernels at (32, 128, 128, 16, 64) bf16 with no
    prefix on a RoBERTa layer's real inputs from 20b (the stage-mask
    forward's from an evaluation forward, the dense-bias forward's and the
    backward's from the held step), each against its plain version, then
    kernel, plain version and SDPA per call and back to back, and the
    bound;
21. (run before 11) the standalone half of ROADMAP item 9: 21a, each of
    the three dispatcher ops (``torch.ops.modcr_torch.*``, which every
    earlier phase already ran through) bit-equal to its direct launcher at
    phase 3's micro-batch-8 shapes and phase 7's training shapes in bf16,
    the stage-mask op's gradients to the direct backward launch,
    ``torch.library.opcheck`` on the card at (2, 24, 24, 2, 64) in fp32
    and bf16, and host µs per call over 1,000 calls with no synchronisation
    inside (and in windows of 100, which time the host alone), direct
    launcher against the op (and a ``custom_op`` twin) in turns; 21b, the full-width bf16 scorer (alignment off) with the device
    feature table against the host path, logits bit-equal, 60 launches a
    forward, collate + copy ms and bytes per micro-batch of 8, then one
    training forward and backward at phase 10's geometry on one model,
    host, table, host (the loss bit-equal; the gradients within 1e-4 of max
    |g| of host mode's, beside host mode against its own second run; 36 /
    48 / 24 launches); 21c, ``serve --save_artifact`` then ``serve --artifact`` as
    processes at full width in bf16, phase 14's clients on the artifact
    command (replies within phase 14's bound of the live scorer, the
    bit-equal ones counted), the artifact loaded in-process bit-equal to
    the live scorer with 57 launches a forward, ms per micro-batch of both
    in turns, export and standup seconds; 21d, ``serve --generate
    --save_gen_artifact`` (started after 21a, exporting beside 21b and
    21c) and ``serve --gen_artifact`` as processes (phase 16's geometry, 32
    greedy steps), the loaded generator's tokens equal
    to live generation with 24 launches a classify forward, the command's
    replies equal to live under phase 16's clients, export seconds,
    program bytes, ms per request of both; 21e, ``Trainer.fit`` at phase
    10's geometry with the table, ``profile_dir`` (two steps captured) and
    ``tensorboard_dir``: the Chrome trace's spec_attention*,
    dense_attention* and flash_bwd* kernels are 36 / 48 / 24 a profiled
    step, and the writer branch that ran is printed;
22. (run before 11) scale-out (parallel/): 22a, world size 1 over NCCL at
    mesh (1, 1): one PMR train step of PARALLEL_EXAMPLES examples at the
    production training geometry (bf16, remat, dropout 0) and one scorer
    micro-batch of 8, bit-equal to the same without a mesh (loss, gradient
    norm, the PARALLEL_PARAMS after the step, logits); 22b, two processes
    sharing the card over gloo (``--parallel-rank``), at meshes (2, 1) and
    (1, 2), the same step (each rank its rows) and micro-batch held to
    world size 1 (PARALLEL_*_TOL), with the kernel counts of each (36 / 48
    / 24 a step, 36 / 24 / 0 a forward, at 6 local encoder heads and 8
    local RoBERTa heads under (1, 2)) and every launch held against its
    plain version (HeldSpec, HeldDense, HeldBackward); the seconds are of
    two processes sharing one card over gloo, not a multi-GPU time; 22c,
    the request features through an ``.mcrpack`` and the native reader
    (``data/feature_store.py``, built from ``native/feature_store.cpp``
    where the committed library does not load): logits equal to the
    pickle's.  ``--only 22d`` (a development aid for a machine of four
    cards, not part of the default run) holds mesh (2, 2) over NCCL, one
    process per card, to world size 1 as 22b holds its processes.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of each output's max |plain|
LAUNCHES_PER_FORWARD = 60
MICRO_BATCHES = (8, 32)
SEED = 0
KERNELS = ("spec_attention", "fused_attention", "flash_bwd")
# per train step of the slice: frozen encoders 12 + 12 + 12 stage-mask
# launches; RoBERTa 24 dense forwards, 24 remat recomputes and 24 backwards
STEP_LAUNCHES = {"spec_attention": 36, "fused_attention": 48, "flash_bwd": 24}
TRAIN_SHAPE = dict(B=128, lq=128, prefix=10, H=16, dh=64)
TRAIN_EXAMPLES, TRAIN_STEPS, VALID_STEPS = 32, 8, 4
# phase 12: examples per file, the train batch (the CLI's default eval batch
# is 16 as well)
CLI_SIZES = {"train": 64, "val": 32, "test": 32, "vcr": 64}
CLI_BATCH = CLI_EVAL_BATCH = 16
LONG_IMG_LEN = 100          # phase 12's last run: 140 + 100 = 240 encoder keys
LONG_KEYS = (240, 520)      # phase 13: past the bf16 kernels' resident 192 keys
# phase 14: concurrent clients, requests per client, examples per request
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_EXAMPLES = 16, 4, (1, 4)
SERVE_MICRO_BATCH = 8
# phase 15: the products the int8 route takes, (rows, in, out): the encoders'
# FFN at micro-batch 8 (32 rows x 190 tokens) and RoBERTa's at 32 (128 x 128)
INT8_SHAPES = {"encoder FFN, micro-batch 8": (6080, 768, 3072),
               "RoBERTa FFN, micro-batch 32": (16384, 1024, 4096)}
INT8_PEAK = 1979e12          # dense int8 operations per second
# phase 16: questions per forward, decode steps; clients, requests per
# client, questions per request
GEN_MICRO_BATCH, GEN_MAX_LEN = 4, 32
GEN_CLIENTS, GEN_REQUESTS, GEN_QUESTIONS = 8, 2, (1, 2)
# phase 17: questions, beams, decode lengths; constraints a question and
# words a constraint (the FSM's S = 2**3 * 3 = 24 states); 17a's depth
BEAM_QUESTIONS, BEAM_WIDTH, BEAM_MAX_LEN, CBS_MAX_LEN = 4, 5, 32, 20
CBS_CONSTRAINTS, CBS_WORDS = 3, 3
BEAM_PARITY_LAYERS, BEAM_PARITY_QUESTIONS, BEAM_PARITY_STEPS, CBS_PARITY_STEPS = 2, 2, 8, 6
# Open-Images-style detections for the box front end: a small hierarchy,
# single-word classes (and blacklisted ones), wordforms for some
DETECTION_HIERARCHY = {"LabelName": "entity", "Subcategory": [
    {"LabelName": "animal", "Subcategory": [
        {"LabelName": "dog"}, {"LabelName": "cat"}, {"LabelName": "horse"}]},
    {"LabelName": "food", "Subcategory": [{"LabelName": "pizza"}, {"LabelName": "sandwich"}]},
    {"LabelName": "vehicle", "Subcategory": [
        {"LabelName": "bicycle"}, {"LabelName": "bus"}, {"LabelName": "train"}]},
]}
DETECTION_CLASSES = ("dog", "cat", "horse", "pizza", "sandwich", "bicycle", "bus", "train",
                     "person", "tree", "man")
DETECTION_WORDFORMS = {"dog": ["dog", "dogs"], "cat": ["cat", "cats"], "bus": ["bus", "buses"]}
# phase 18: questions (4 rows each) a training step, steps, explanation
# length; 18a's encoder depth
RATIONALE_QUESTIONS, RATIONALE_STEPS, RATIONALE_LEN = 8, 6, 32
RATIONALE_PARITY_LAYERS = 3
# phase 19: questions a step in both stages (the JAX script's default
# --stage1_batch), steps of each stage, the validation cadence, PMR examples
TWO_STAGE_QUESTIONS, STAGE1_STEPS, STAGE2_STEPS, TWO_STAGE_VALID = 16, 8, 4, 4
TWO_STAGE_EXAMPLES = 96
# phase 20: questions a DualEnsembleModel forward (4 rows each); images of
# the CLIP towers' call (4 id rows each); the command's examples and images
ENSEMBLE_QUESTIONS, CLIP_IMAGES = 8, 32
CLIP_CMD_EXAMPLES, CLIP_CMD_IMAGES = 32, 16
ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 22: the global batch of the two-process step; its meshes; the bounds
# of a two-process bf16 step and forward against world size 1 (|loss|, the
# gradient norm relative, parameters after the step in learning rates: one
# AdamW step moves each by about lr, so a flipped update differs by 2 lr;
# logits over max |logit|), and the parameters read back after the step
PARALLEL_EXAMPLES = 16
PARALLEL_SEED = SEED + 22
PARALLEL_MESHES = ((2, 1), (1, 2))
PARALLEL_LOSS_TOL, PARALLEL_NORM_TOL = 2e-2, 5e-2
PARALLEL_PARAM_TOL_LR, PARALLEL_LOGIT_TOL = 2.5, 5e-2
PARALLEL_PARAMS = ("roberta.encoder.layer.0.attention.self.query.weight",
                   "roberta.encoder.layer.0.attention.self.query.bias",
                   "roberta.encoder.layer.23.output.dense.weight",
                   "roberta.encoder.layer.23.output.dense.bias",
                   "roberta.encoder.layer.23.output.LayerNorm.weight",
                   "mapping_network_vision.1.weight", "abst_confidence_scorer.weight")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs

def chunk_ids(rng, length: int) -> np.ndarray:
    """Chunk ids over positions 1..length-2 the way the featurizer lays
    them out: runs of 1-4 tokens, some positions outside any chunk."""
    gi = np.full(length, -1, np.int32)
    t, cid = 1, 0
    while t < length - 1:
        run = int(rng.integers(1, 5))
        if rng.random() < 0.2:
            t += run
            continue
        gi[t:min(t + run, length - 1)] = cid
        cid += 1
        t += run
    return gi


def attention_case(rng, name, B, T, I, H, stage, lq=None, prefix=0, dh=64):
    """q, k, v and the stage's mask vectors at one ModCR shape."""
    from multimodal_context_reasoning_torch.ops.masks import stage_mask_specs

    if stage == "roberta":  # full stage over [prefix ‖ tokens]
        lens = rng.integers(20, lq + 1, B)
        valid = np.zeros((B, prefix + lq), np.float32)
        valid[:, :prefix] = 1.0
        for b, n in enumerate(lens):
            valid[b, prefix:prefix + n] = 1.0
        lk = prefix + lq
        vecs = (torch.from_numpy(valid), torch.full((B, lk), -1, dtype=torch.int32),
                torch.zeros(B, lk))
        stage, text_len = "full", lq
    else:
        text_mask = np.zeros((B, T), np.float32)
        gather = np.full((B, T), -1, np.int32)
        for b, n in enumerate(rng.integers(min(T, max(2, T // 4)), T + 1, B)):
            text_mask[b, :n] = 1.0
            gather[b, :n] = chunk_ids(rng, int(n))
        img_mask = np.zeros((B, I), np.float32)
        for b, n in enumerate(rng.integers(10, I + 1, B)):
            img_mask[b, :n] = 1.0
        spec = stage_mask_specs(torch.from_numpy(text_mask), torch.from_numpy(img_mask),
                                torch.from_numpy(gather))[("chunk", "full", "cross").index(stage)]
        vecs = (spec.valid, spec.gi, spec.rowfull)
        lq = lk = T + I
        text_len = T
    q = torch.from_numpy(rng.standard_normal((B, lq, H, dh), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, lk, H, dh), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, lk, H, dh), dtype=np.float32))
    return dict(name=name, q=q, k=k, v=v, vecs=vecs, stage=stage, text_len=text_len)


def shapes(rng, mb: int):
    """(case, launches per forward) for the five ModCR shapes of a
    micro-batch of ``mb`` examples: ``4 * mb`` candidate rows, and ``mb``
    rows on the deduplicated vision pass."""
    n = 4 * mb
    return [
        (attention_case(rng, f"mb{mb} vision full L=51", mb, 1, 50, 12, "full"), 12),
        (attention_case(rng, f"mb{mb} encoder chunk L=190", n, 140, 50, 12, "chunk"), 3),
        (attention_case(rng, f"mb{mb} encoder full L=190", n, 140, 50, 12, "full"), 18),
        (attention_case(rng, f"mb{mb} encoder cross L=190", n, 140, 50, 12, "cross"), 3),
        (attention_case(rng, f"mb{mb} roberta full Lq=128 Lk=138", n, 0, 0, 16,
                        "roberta", lq=128, prefix=10), 24),
    ]


def cuda_args(case, dtype):
    q, k, v = (case[n].to("cuda", dtype) for n in ("q", "k", "v"))
    valid, gi, rowfull = (t.cuda().contiguous() for t in case["vecs"])
    return q, k, v, valid, gi, rowfull


# ---------------------------------------------------------------- timing

def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, n: int = 25, windows: int = 5, warmup: int = 3) -> float:
    """Median over ``windows`` event windows of ``n`` calls back to back, per
    call: the host's launch work overlaps the device's, unlike ``median_ms``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(case, dtype):
    """Least time for the work: bytes (q, k, v and the mask vectors read
    once, out written once) over HBM rate vs FLOPs over the dtype's peak."""
    q, k = case["q"], case["k"]
    B, lq, H, dh = q.shape
    lk = k.shape[1]
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (2 * B * lq * H * dh + 2 * B * lk * H * dh) + 12 * B * lk
    flops = 4.0 * B * H * lq * lk * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, valid, gi, rowfull, case):
    from multimodal_context_reasoning_torch.ops.spec_attention import stage_visibility

    mask = stage_visibility(valid, gi, rowfull, stage=case["stage"],
                            text_len=case["text_len"], lq=q.shape[1]) > 0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = mask[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


# ---------------------------------------------------------------- training

def wrappers():
    """Each kernel's wrapper, by kernel name: their ``launches`` counters."""
    from multimodal_context_reasoning_torch.ops.flash import flash_attention_bwd
    from multimodal_context_reasoning_torch.ops.fused_attention import fused_attention
    from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

    return {"spec_attention": fused_attention_spec, "fused_attention": fused_attention,
            "flash_bwd": flash_attention_bwd}


def reset_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


@contextlib.contextmanager
def uncounted():
    """Launches made inside compare a kernel with its plain version; they
    are not the path's, so the counts are left as they were."""
    before = read_counts()
    try:
        yield
    finally:
        for name, w in wrappers().items():
            w.launches = before[name]


def dense_case(rng, B, lq, prefix, H, dh):
    """q, k, v, a random dO and the validity of RoBERTa's prefixed KV stream
    (the prefix slots always valid, 20 to Lq real tokens) at a training shape."""
    lk = prefix + lq
    valid = np.zeros((B, lk), np.float32)
    valid[:, :prefix] = 1.0
    for b, n in enumerate(rng.integers(20, lq + 1, B)):
        valid[b, prefix:prefix + n] = 1.0
    normal = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return dict(q=normal(B, lq, H, dh), k=normal(B, lk, H, dh), v=normal(B, lk, H, dh),
                d_out=normal(B, lq, H, dh), valid=torch.from_numpy(valid))


def errors(got, want):
    """(max |got - want|, that over max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def spec_grad_errors(q, k, v, vecs, d_out, **kw):
    """The stage-mask op's q, k, v gradients (kernel forward, backward
    kernel) against autograd of its plain version: worst (abs, rel)."""
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fused_attention_spec(*leaves, *vecs, **kw).backward(d_out)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    spec_attention_plain(*ref, *vecs, **kw).backward(d_out)
    torch.cuda.synchronize()
    errs = [errors(a.grad, b.grad) for a, b in zip(leaves, ref)]
    check(all(torch.isfinite(a.grad).all().item() for a in leaves), "non-finite spec grads")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_training_kernels(rng) -> dict:
    """Phase 7; returns the worst absolute error of each kernel."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )
    from multimodal_context_reasoning_torch.ops.masks import full_mask_spec, padding_bias
    from multimodal_context_reasoning_torch.ops.spec_attention import spec_bias

    worst = {"fused_attention": 0.0, "flash_bwd": 0.0, "spec_attention": 0.0}
    case = dense_case(rng, **TRAIN_SHAPE)
    masked = dense_case(rng, 4, 30, 10, 4, 64)
    masked["valid"][1] = 0.0                  # a batch row with no visible key
    chunk = attention_case(rng, "chunk L=190", 32, 140, 50, 12, "chunk")
    for name, c in (("roberta (128, 128, 138, 16, 64)", case),
                    ("fully masked row", masked)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, d_out = (c[n].to("cuda", dtype) for n in ("q", "k", "v", "d_out"))
            valid = c["valid"].cuda()
            bias = padding_bias(valid)
            got = fused_attention(q, k, v, bias)
            torch.cuda.synchronize()
            f_err, _ = errors(got, fused_attention_plain(q, k, v, bias))
            check(torch.isfinite(got).all().item() and f_err <= TOL[dtype],
                  f"dense forward {name} {dtype}: {f_err}")
            worst["fused_attention"] = max(worst["fused_attention"], f_err)
            got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True)
            torch.cuda.synchronize()
            want = flash_attention_bwd_plain(q, k, v, bias, d_out)
            line = []
            for out, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                err, rel = errors(g, w)
                check(torch.isfinite(g).all().item() and rel <= BWD_TOL[dtype],
                      f"backward {out} {name} {dtype}: rel {rel}")
                worst["flash_bwd"] = max(worst["flash_bwd"], err)
                line.append(f"{out} {err:.2e} ({rel:.1e} rel)")
            spec = full_mask_spec(valid, q.shape[1])
            s_err, s_rel = spec_grad_errors(q, k, v, (spec.valid, spec.gi, spec.rowfull),
                                            d_out, stage="full", text_len=q.shape[1])
            check(s_rel <= BWD_TOL[dtype], f"spec grads full {name} {dtype}: rel {s_rel}")
            worst["spec_attention"] = max(worst["spec_attention"], s_err)
            print(f"[7 train check] {name:32s} {str(dtype):15s} forward {f_err:.2e} | "
                  "backward " + " | ".join(line)
                  + f" | spec-op grads {s_err:.2e} ({s_rel:.1e} rel)")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, *vecs = cuda_args(chunk, dtype)
        d_out = torch.randn(q.shape, device="cuda", dtype=dtype,
                            generator=torch.Generator("cuda").manual_seed(SEED))
        s_err, s_rel = spec_grad_errors(q, k, v, vecs, d_out, stage="chunk",
                                        text_len=chunk["text_len"])
        check(s_rel <= BWD_TOL[dtype], f"spec grads chunk {dtype}: rel {s_rel}")
        worst["spec_attention"] = max(worst["spec_attention"], s_err)
        print(f"[7 train check] {'chunk (32, 190, 190, 12, 64)':32s} {str(dtype):15s} "
              f"spec-op grads {s_err:.2e} ({s_rel:.1e} rel)")
    # bf16 at the chunk stage's length, the longest keys the tensor-core
    # kernels take on the model's path, with the stage's [B, 1, Lq, Lk] mask
    # plane: the forward, then the backward
    q, k, v, *vecs = cuda_args(chunk, torch.bfloat16)
    bias = spec_bias(*vecs, stage="chunk", text_len=chunk["text_len"], lq=q.shape[1])
    got = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    f_err, f_rel = errors(got, fused_attention_plain(q, k, v, bias))
    check(torch.isfinite(got).all().item() and f_rel <= TOL[torch.bfloat16],
          f"dense forward L=190 plane bf16: rel {f_rel}")
    worst["fused_attention"] = max(worst["fused_attention"], f_err)
    print(f"[7 train check] {'chunk plane (32, 190, 190, 12, 64)':32s} {'torch.bfloat16':15s} "
          f"forward {f_err:.2e} ({f_rel:.1e} rel)")
    d_out = torch.randn(q.shape, device="cuda", dtype=torch.bfloat16,
                        generator=torch.Generator("cuda").manual_seed(SEED + 3))
    got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    line = []
    for out, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        err, rel = errors(g, w)
        check(torch.isfinite(g).all().item() and rel <= BWD_TOL[torch.bfloat16],
              f"backward {out} L=190 bf16: rel {rel}")
        worst["flash_bwd"] = max(worst["flash_bwd"], err)
        line.append(f"{out} {err:.2e} ({rel:.1e} rel)")
    print(f"[7 train check] {'chunk plane (32, 190, 190, 12, 64)':32s} {'torch.bfloat16':15s} "
          "backward " + " | ".join(line))
    del got, want
    q, k, v, d_out = (case[n].to("cuda", torch.bfloat16) for n in ("q", "k", "v", "d_out"))
    bias = padding_bias(case["valid"].cuda())
    runs = [flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)[:3] for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[7 train check] bf16 backward, two launches at (128, 128, 138, 16, 64): "
          f"dq, dk, dv bit-equal {same}")
    check(same, "bf16 backward: two launches differ")
    print(f"[7 train check] worst |kernel - plain|: {worst} (forward tol {TOL}, "
          f"backward tol of max |plain| {BWD_TOL})")
    return worst


def train_bound(case, dtype, kind: str):
    """Least time: bytes (each input read once, each output written once)
    over HBM rate vs FLOPs over the dtype's peak.  Forward: q, k, v, bias
    in, out out; 2 products.  Backward: q, k, v, dO, bias in, dq, dk, dv out
    (no dbias plane, as the model calls it); 5 products."""
    B, lq, H, dh = case["q"].shape
    lk = case["k"].shape[1]
    elt = torch.finfo(dtype).bits // 8
    qn, kn = B * lq * H * dh, B * lk * H * dh
    if kind == "forward":
        nbytes, flops = elt * (2 * qn + 2 * kn) + 4 * B * lk, 4.0 * B * H * lq * lk * dh
    else:
        nbytes, flops = elt * (3 * qn + 4 * kn) + 4 * B * lk, 10.0 * B * H * lq * lk * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_training_kernels(rng) -> dict:
    """Phase 8: bf16 at the training shape; returns the kernels-line numbers."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )
    from multimodal_context_reasoning_torch.ops.masks import padding_bias

    dt = torch.bfloat16
    case = dense_case(rng, **TRAIN_SHAPE)
    q, k, v, d_out = (case[n].to("cuda", dt) for n in ("q", "k", "v", "d_out"))
    bias = padding_bias(case["valid"].cuda())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = bias.to(dt)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    qt, kt, vt = (t.detach().requires_grad_() for t in (q4, k4, v4))
    out_t = sdpa(qt, kt, vt, attn_mask=mask)
    d_out_t = d_out.transpose(1, 2)
    rows = {}
    for name, kind, kernel, plain, library in (
        ("fused_attention", "forward", lambda: fused_attention(q, k, v, bias),
         lambda: fused_attention_plain(q, k, v, bias),
         lambda: sdpa(q4, k4, v4, attn_mask=mask)),
        ("flash_bwd", "backward",
         lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False),
         lambda: flash_attention_bwd_plain(q, k, v, bias, d_out),
         lambda: torch.autograd.grad(out_t, (qt, kt, vt), d_out_t, retain_graph=True)),
    ):
        ms, plain_ms, lib_ms = median_ms(kernel), median_ms(plain), median_ms(library)
        b2b_ms, lib_b2b_ms = back_to_back_ms(kernel), back_to_back_ms(library)
        b_ms, b_by = train_bound(case, dt, kind)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, back_to_back_ms=b2b_ms,
                          library_back_to_back_ms=lib_b2b_ms)
        print(f"[8 train time] {name:16s} bf16 (128, 128, 138, 16, 64): kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | sdpa {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) "
              f"| kernel at {b_ms / ms:.2%} of its bound")
        print(f"[8 train time] {name:16s} 25 back to back, per launch: kernel {b2b_ms:.4f} ms "
              f"({b_ms / b2b_ms:.2%} of its bound) | sdpa {lib_b2b_ms:.4f} ms | "
              f"kernel / sdpa {b2b_ms / lib_b2b_ms:.2f}")
    dbias_ms = median_ms(lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True))
    print(f"[8 train time] flash_bwd with the dbias plane (not on the model's path): "
          f"{dbias_ms:.4f} ms")
    return rows


def training_parity(rng) -> dict:
    """Phase 9: two fp32 train steps, card against CPU, remat off."""
    from multimodal_context_reasoning_torch.core.config import TrainConfig, pmr_training_config
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.state import TrainState
    from multimodal_context_reasoning_torch.train.step import train_step

    cfg = pmr_training_config(dtype="float32", remat=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = ModCRModel(cfg, device="cuda", generator=gen)
    cpu_model = ModCRModel(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = synthetic_dataset(rng, 1, cfg).batch([0])
    runs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        state = TrainState.create(m, TrainConfig(), total_steps=10)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        reset_counts()
        t0 = time.perf_counter()
        metrics = [train_step(state, tb) for _ in range(2)]
        runs[dev] = dict(loss=[float(x["loss"]) for x in metrics],
                         grad_norm=[float(x["grad_norm"]) for x in metrics],
                         seconds=time.perf_counter() - t0, launches=read_counts())
        del state
    rel = max(abs(a - b) / abs(b) for key in ("loss", "grad_norm")
              for a, b in zip(runs["cuda"][key], runs["cpu"][key]))
    print(f"[9 train parity] full-width fp32, 1 example (4 rows), 2 steps, remat off: "
          f"cuda loss {runs['cuda']['loss']} grad_norm {runs['cuda']['grad_norm']} | "
          f"cpu loss {runs['cpu']['loss']} grad_norm {runs['cpu']['grad_norm']} | "
          f"max rel diff {rel:.3e} (tol 1e-4) | card launches {runs['cuda']['launches']} | "
          f"cpu {runs['cpu']['seconds']:.1f} s")
    check(all(np.isfinite(runs["cuda"][k]).all() for k in ("loss", "grad_norm")),
          "non-finite fp32 training metrics")
    check(rel <= 1e-4, f"training parity: rel diff {rel}")
    check(runs["cuda"]["launches"]["flash_bwd"] == 2 * 24
          and runs["cuda"]["launches"]["spec_attention"] == 2 * 60,
          f"fp32 remat-off launches {runs['cuda']['launches']}")
    return dict(max_rel_diff=rel, cuda=runs["cuda"], cpu=runs["cpu"])


def counted(fn, log):
    """``fn`` that appends its seconds (synchronized), result and kernel
    launches to ``log`` on each call."""
    def run(*args):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        after = read_counts()
        log.append(dict(seconds=time.perf_counter() - t0, out=out,
                        launches={k: after[k] - before[k] for k in after}))
        return out
    return run


def train_slice(rng) -> dict:
    """Phase 10, the slice's main path: Trainer.fit at full width."""
    from multimodal_context_reasoning_torch.core.config import TrainConfig, pmr_training_config
    from multimodal_context_reasoning_torch.data.loader import DataLoader
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.trainer import Trainer

    cfg = pmr_training_config()
    model = ModCRModel(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    train_ds = synthetic_dataset(rng, TRAIN_EXAMPLES * TRAIN_STEPS, cfg, first=10_000)
    val_ds = synthetic_dataset(rng, 2 * TRAIN_EXAMPLES, cfg, first=20_000)
    tcfg = TrainConfig(per_device_batch_size=TRAIN_EXAMPLES, max_steps=TRAIN_STEPS,
                       valid_steps=VALID_STEPS, epoch_begin=1, seed=SEED)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if "_enc." in n}
    ckpt_dir = tempfile.mkdtemp(prefix="modcr_ckpt_")
    trainer = Trainer(model, tcfg, DataLoader(train_ds, TRAIN_EXAMPLES, shuffle=True, seed=SEED),
                      DataLoader(val_ds, TRAIN_EXAMPLES), checkpoint_dir=ckpt_dir,
                      checkpoint_params_only=True)
    trainer.best_acc = -1.0   # the first validation saves a checkpoint
    steps, evals, saves = [], [], []

    trainer.train_step = counted(trainer.train_step, steps)
    trainer.eval_step = counted(trainer.eval_step, evals)
    trainer.ckpt.save = counted(trainer.ckpt.save, saves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    saved = trainer.ckpt.all_steps()
    shutil.rmtree(ckpt_dir)

    losses = [float(s["out"]["loss"]) for s in steps]
    check(len(steps) == TRAIN_STEPS and state.step == TRAIN_STEPS,
          f"{len(steps)} train steps, state at {state.step}")
    check(np.isfinite(losses).all(), f"non-finite losses {losses}")
    for i, s in enumerate(steps):
        check(s["launches"] == STEP_LAUNCHES, f"step {i}: launches {s['launches']}")
    check(all(p.dtype == torch.float32 for p in model.parameters()), "parameters left fp32")
    check(all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen),
          "a frozen encoder weight changed")
    check(bool(saved) and len(trainer.history) == TRAIN_STEPS // VALID_STEPS,
          f"checkpoints {saved}, validations {trainer.history}")
    check(all(launches[k] > 0 for k in KERNELS), f"main-path launches {launches}")
    step_ms = [1e3 * s["seconds"] for s in steps]
    steady = statistics.median(step_ms[1:])
    val_launches = {k: sum(e["launches"][k] for e in evals) for k in KERNELS}
    print(f"[10 train] bf16 production geometry, remat full, dropout 0, "
          f"{TRAIN_EXAMPLES} examples ({4 * TRAIN_EXAMPLES} rows) per step: losses "
          f"{np.round(losses, 4).tolist()}")
    print(f"[10 train] ms per step {np.round(step_ms, 2).tolist()} -> steady (median of "
          f"steps 2-{TRAIN_STEPS}) {steady:.2f} ms = {TRAIN_EXAMPLES / steady * 1e3:.2f} "
          f"examples/s | fit wall {wall:.2f} s (validation, checkpoint and data included) "
          f"| peak {peak:.2f} GiB")
    print(f"[10 train] launches per train step {steps[0]['launches']} (all {TRAIN_STEPS} "
          f"equal), {len(evals)} validation forwards launched {val_launches} | validation "
          f"{[round(h['val_acc'], 4) for h in trainer.history]} | checkpoints "
          f"{[round(s['seconds'], 2) for s in saves]} s, kept steps {saved} | all of fit "
          f"{launches}")
    return dict(launches=launches, steady_ms_per_step=steady,
                examples_per_s=TRAIN_EXAMPLES / steady * 1e3, peak_gib=peak,
                ms_per_step=step_ms, losses=losses, fit_seconds=wall,
                validation_launches=val_launches,
                checkpoint_seconds=[s["seconds"] for s in saves])


def time_training_spec_shapes(rng) -> list:
    """Phase 4b: the stage-mask kernel at the frozen encoders' shapes of a
    32-example training step, bf16: kernel, plain version and SDPA, per call
    and back to back."""
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )

    rows = []
    for case in (
        attention_case(rng, "train encoder full (128, 190, 190, 12, 64)", 128, 140, 50, 12,
                       "full"),
        attention_case(rng, "train encoder chunk (128, 190, 190, 12, 64)", 128, 140, 50, 12,
                       "chunk"),
        attention_case(rng, "train vision full (32, 51, 51, 12, 64)", 32, 1, 50, 12, "full"),
    ):
        args = cuda_args(case, torch.bfloat16)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        kernel = lambda: fused_attention_spec(*args, **kw)
        plain = lambda: spec_attention_plain(*args, **kw)
        sdpa = sdpa_call(*args, case)
        b_ms, b_by = bound(case, torch.bfloat16)
        row = dict(shape=case["name"], ms=median_ms(kernel), plain_ms=median_ms(plain),
                   library_ms=median_ms(sdpa), b2b_ms=back_to_back_ms(kernel),
                   plain_b2b_ms=back_to_back_ms(plain), library_b2b_ms=back_to_back_ms(sdpa),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"[4b train shapes] {case['name']:44s} per call: kernel {row['ms']:.4f} | plain "
              f"{row['plain_ms']:.4f} | sdpa {row['library_ms']:.4f} ms; back to back: kernel "
              f"{row['b2b_ms']:.4f} | plain {row['plain_b2b_ms']:.4f} | sdpa "
              f"{row['library_b2b_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
        del args
    return rows


def spec_launches_per_eval_forward(cfg) -> int:
    """Stage-mask launches of one deterministic forward: the global encoder
    twice (the vision pass and the text-image pass), the ChunkAlign encoder
    without its cross-stage layers when they return the alignment
    probabilities, and every RoBERTa layer unless ``remat`` or
    ``scan_layers`` gives them the dense bias (they take the dense-bias
    forward then).  Full width with the alignment loss on: 12 + 12 + (12 -
    3) + 24 = 57."""
    cross = cfg.seq_encoder.num_hidden_layers - cfg.chunkalign.full_layers_end
    dense = cfg.roberta.remat or cfg.roberta.scan_layers
    return (2 * cfg.global_encoder.num_hidden_layers + cfg.seq_encoder.num_hidden_layers
            - (cross if cfg.compute_alignment else 0)
            + (0 if dense else cfg.roberta.num_hidden_layers))


def cli_phase(rng) -> dict:
    """Phase 12: ``run_pmr --do_train``, ``run_pmr --do_test`` from its
    checkpoint and ``run_vcr --do_train`` through ``main(argv)``, full
    width, bf16, at the reference defaults otherwise (dropout 0.1 in
    RoBERTa, the encoders' ``--drop_out``, the alignment loss on), on data
    written from the seed; then the bf16 key-limit refusal."""
    from multimodal_context_reasoning_torch.cli import run_pmr, run_vcr
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.serving.synthetic import (
        region_features,
        task_rows,
        write_rows,
    )
    from multimodal_context_reasoning_torch.train import trainer as trainer_mod

    cfg = ModCRConfig()
    tmp = tempfile.mkdtemp(prefix="modcr_cli_")
    path = lambda name: f"{tmp}/{name}"
    rows = {"train": task_rows(rng, CLI_SIZES["train"], cfg.img_len, first=0),
            "val": task_rows(rng, CLI_SIZES["val"], cfg.img_len, first=10_000),
            "test": task_rows(rng, CLI_SIZES["test"], cfg.img_len, first=20_000),
            "vcr": task_rows(rng, CLI_SIZES["vcr"], cfg.img_len, vcr=True, first=30_000)}
    for name, r in rows.items():
        write_rows(path(f"{name}.jsonl"), r)
    feats = region_features(rng, sum(rows.values(), []), cfg.img_len,
                            cfg.global_encoder.img_feature_dim)
    with open(path("feats.pkl"), "wb") as f:
        pickle.dump({k: {"features": v} for k, v in feats.items()}, f)
    write_pack(feats, path("feats.mcrpack"))
    common = ["--per_gpu_train_batch_size", str(CLI_BATCH), "--compute_dtype", "bfloat16",
              "--seed", str(SEED)]
    per_forward = spec_launches_per_eval_forward(cfg)
    steps, evals, snapshots = [], [], []
    train_step, eval_step = trainer_mod.train_step, trainer_mod.eval_step
    fit = trainer_mod.Trainer.fit

    def snapshot_fit(self, state=None):
        if self.freeze_roberta_body:   # run_vcr: what its checks compare
            snapshots.append({n: p.detach().clone() for n, p in self.model.named_parameters()
                              if n.startswith(("roberta.", "mapping_network_"))})
        return fit(self, state)

    trainer_mod.train_step = counted(train_step, steps)
    trainer_mod.eval_step = counted(eval_step, evals)
    run_pmr.eval_step = counted(eval_step, evals)
    trainer_mod.Trainer.fit = snapshot_fit
    out: dict = {}
    try:
        reset_counts()
        # 1. PMR training at the reference defaults
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_pmr.main(["--do_train", "--train_file", path("train.jsonl"),
                      "--val_file", path("val.jsonl"), "--img_feat_file", path("feats.pkl"),
                      "--output_dir", path("pmr"), "--max_steps", "4", "--valid_steps", "2",
                      "--epoch_begin", "0", *common])
        train_wall = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(s["out"]["loss"]) for s in steps]
        step_ms = [1e3 * s["seconds"] for s in steps]
        check(len(steps) == 4 and np.isfinite(losses).all(), f"PMR train losses {losses}")
        check(all(all(v == 0 for v in s["launches"].values()) for s in steps),
              f"train steps under dropout launched {[s['launches'] for s in steps]}")
        ckpts = [d for d in os.listdir(path("pmr/ckpt")) if d.isdigit()]
        check(bool(ckpts) and os.path.exists(path("pmr/config.json")),
              f"checkpoints {ckpts}, config.json written")
        val_counts = [e["launches"]["spec_attention"] for e in evals]
        check(len(evals) == 2 * CLI_SIZES["val"] // CLI_EVAL_BATCH
              and all(c == per_forward for c in val_counts),
              f"validation forwards launched {val_counts}, {per_forward} each expected")
        steady = statistics.median(step_ms[1:])
        out["pmr_train"] = dict(losses=losses, ms_per_step=step_ms, steady_ms_per_step=steady,
                                examples_per_s=CLI_BATCH / steady * 1e3, peak_gib=train_peak,
                                wall_s=train_wall, validation_launches=val_counts,
                                checkpoints=ckpts)
        print(f"[12 cli] run_pmr --do_train, bf16 full width, {CLI_BATCH} examples a step, "
              f"dropout on, alignment loss on: losses {np.round(losses, 4).tolist()} | ms per "
              f"step {np.round(step_ms, 2).tolist()} -> steady (median of steps 2-4) "
              f"{steady:.2f} ms = {CLI_BATCH / steady * 1e3:.2f} examples/s | peak "
              f"{train_peak:.2f} GiB | main() {train_wall:.2f} s | train-step launches 0 "
              f"(dropout: plain attention) | validation forwards {val_counts} stage-mask "
              f"launches | checkpoints {ckpts}")

        # 2. PMR test from that run's best checkpoint, features from the .mcrpack
        del evals[:]
        t0 = time.perf_counter()
        acc = run_pmr.main(["--do_test", "--test_file", path("test.jsonl"),
                            "--img_feat_file", path("feats.mcrpack"),
                            "--eval_model_dir", path("pmr"), "--output_dir", path("pmr_test"),
                            *common])
        test_wall = time.perf_counter() - t0
        with open(path("pmr_test/result_test_ModICR_pmr.json")) as f:
            preds = [json.loads(line) for line in f]
        test_counts = [e["launches"]["spec_attention"] for e in evals]
        n_forwards = -(-CLI_SIZES["test"] // CLI_EVAL_BATCH)
        check(len(preds) == CLI_SIZES["test"] and all(0 <= p["prediction"] < 4 for p in preds),
              f"{len(preds)} prediction lines")
        check(len(evals) == n_forwards and all(c == per_forward for c in test_counts),
              f"test forwards launched {test_counts}, {per_forward} each expected")
        test_forward_s = sum(e["seconds"] for e in evals)
        out["pmr_test"] = dict(accuracy=acc, forwards=len(evals), spec_launches=test_counts,
                               launches_per_forward=per_forward,
                               examples_per_s=CLI_SIZES["test"] / test_forward_s,
                               wall_s=test_wall)
        print(f"[12 cli] run_pmr --do_test --eval_model_dir (.mcrpack features): "
              f"{len(preds)} prediction lines, accuracy {acc:.4f} | {len(evals)} forwards "
              f"launched {test_counts} stage-mask kernels ({per_forward} each expected) | "
              f"{CLI_SIZES['test'] / test_forward_s:.2f} examples/s over the forwards | "
              f"main() {test_wall:.2f} s")
        shutil.rmtree(path("pmr"))

        # 3. VCR training: the RoBERTa body frozen, 4 accumulated micro-batches
        del steps[:], snapshots[:]
        t0 = time.perf_counter()
        state = run_vcr.main(["--do_train", "--train_file", path("vcr.jsonl"),
                              "--img_feat_file", path("feats.pkl"), "--output_dir", path("vcr"),
                              "--max_steps", "2", *common])
        vcr_wall = time.perf_counter() - t0
        start = snapshots[0]
        params = dict(state.model.named_parameters())
        body = [n for n in params if n.startswith("roberta.encoder.")]
        moved = ("roberta.embeddings.word_embeddings.weight", "mapping_network_vision.1.weight",
                 "mapping_network_alignment.4.weight")
        vcr_losses = [float(s["out"]["loss"]) for s in steps]
        check(len(steps) == 8 and state.step == 8 and np.isfinite(vcr_losses).all(),
              f"VCR micro-steps {len(steps)}, losses {vcr_losses}")
        check(bool(body) and all(torch.equal(params[n], start[n]) for n in body),
              "a frozen RoBERTa body weight changed")
        check(all(not torch.equal(params[n], start[n]) for n in moved),
              "RoBERTa embeddings or a mapping network did not train")
        out["vcr_train"] = dict(losses=vcr_losses, micro_steps=len(steps), wall_s=vcr_wall,
                                body_tensors_unchanged=len(body))
        print(f"[12 cli] run_vcr --do_train: {len(steps)} micro-steps (2 optimizer steps of 4) "
              f"losses {np.round(vcr_losses, 4).tolist()} | {len(body)} RoBERTa body tensors "
              f"bit-unchanged, {', '.join(moved)} changed | main() {vcr_wall:.2f} s")
        del state, params, start, snapshots[:]

        # 4. --do_test at --max_img_seq_length 100: 240 encoder keys, past the
        # 192 the bf16 kernels hold resident (their key-looped instances)
        long_feats = region_features(rng, rows["test"], LONG_IMG_LEN,
                                     cfg.global_encoder.img_feature_dim)
        with open(path("feats_long.pkl"), "wb") as f:
            pickle.dump({k: {"features": v} for k, v in long_feats.items()}, f)
        del evals[:]
        t0 = time.perf_counter()
        long_acc = run_pmr.main(["--do_test", "--max_img_seq_length", str(LONG_IMG_LEN),
                                 "--test_file", path("test.jsonl"),
                                 "--img_feat_file", path("feats_long.pkl"),
                                 "--output_dir", path("pmr_long"), *common])
        long_wall = time.perf_counter() - t0
        with open(path("pmr_long/result_test_ModICR_pmr.json")) as f:
            long_preds = [json.loads(line) for line in f]
        long_counts = [e["launches"]["spec_attention"] for e in evals]
        check(len(long_preds) == CLI_SIZES["test"]
              and all(0 <= p["prediction"] < 4 for p in long_preds),
              f"{len(long_preds)} prediction lines at {LONG_IMG_LEN} regions")
        check(len(evals) == n_forwards and all(c == per_forward for c in long_counts),
              f"240-key test forwards launched {long_counts}, {per_forward} each expected")
        long_forward_s = sum(e["seconds"] for e in evals)
        out["pmr_test_240_keys"] = dict(
            accuracy=long_acc, forwards=len(evals), spec_launches=long_counts,
            examples_per_s=CLI_SIZES["test"] / long_forward_s, wall_s=long_wall)
        print(f"[12 cli] run_pmr --do_test --max_img_seq_length {LONG_IMG_LEN} (140 + "
              f"{LONG_IMG_LEN} = {140 + LONG_IMG_LEN} encoder keys, bf16, random init): "
              f"{len(long_preds)} prediction lines | {len(evals)} forwards launched "
              f"{long_counts} stage-mask kernels ({per_forward} each expected) | "
              f"{CLI_SIZES['test'] / long_forward_s:.2f} examples/s over the forwards | "
              f"main() {long_wall:.2f} s")
        out["launches"] = read_counts()
    finally:
        trainer_mod.train_step, trainer_mod.eval_step = train_step, eval_step
        run_pmr.eval_step, trainer_mod.Trainer.fit = eval_step, fit
        shutil.rmtree(tmp)
    check(out["launches"]["spec_attention"] > 0, f"phase 12 launches {out['launches']}")
    print(f"[12 cli] launches over the phase {out['launches']}")
    return out


def long_key_phase(rng) -> dict:
    """Phase 13: every route past the bf16 kernels' resident 192 keys and
    past the fp32 kernels' shared memory, against the plain versions at
    Lk 240 and 520; then bf16 kernel, plain version, SDPA and bound at
    (128, 240, 240, 12, 64) in the full and chunk stages and at the RoBERTa
    training shape with Lk 240 (128, 230, 240, 16, 64), dense forward and
    backward.  Returns the worst absolute error per kernel and the timings."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )
    from multimodal_context_reasoning_torch.ops.masks import padding_bias
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
        spec_bias,
    )

    worst = {k: 0.0 for k in KERNELS}

    def hold(kernel, what, got, want, dtype, relative):
        err, rel = errors(got, want)
        ok = torch.isfinite(got).all().item() and (
            rel <= BWD_TOL[dtype] if relative else err <= TOL[dtype])
        check(ok, f"long keys {kernel} {what} {dtype}: abs {err} rel {rel}")
        worst[kernel] = max(worst[kernel], err)
        return f"{err:.2e}" + (f" ({rel:.1e} rel)" if relative else "")

    for L in LONG_KEYS:
        for dtype in (torch.float32, torch.bfloat16):
            line = []
            for stage in ("full", "chunk", "cross"):
                case = attention_case(rng, f"L={L} {stage}", 32, 140, L - 140, 12, stage)
                args = cuda_args(case, dtype)
                kw = dict(stage=case["stage"], text_len=case["text_len"])
                got = fused_attention_spec(*args, **kw)
                torch.cuda.synchronize()
                line.append(f"spec {stage} " + hold("spec_attention", f"{stage} L={L}", got,
                                                     spec_attention_plain(*args, **kw), dtype,
                                                     False))
                if stage == "chunk":   # its mask plane as the dense routes' bias
                    q, k, v, *vecs = args
                    plane = spec_bias(*vecs, stage="chunk", text_len=case["text_len"],
                                      lq=q.shape[1])
                    d_out = torch.randn(q.shape, device="cuda", dtype=dtype,
                                        generator=torch.Generator("cuda").manual_seed(L))
                del args, got
            row = dense_case(rng, 32, L - 10, 10, 12, 64)
            rq, rk, rv, rd = (row[n].to("cuda", dtype) for n in ("q", "k", "v", "d_out"))
            rbias = padding_bias(row["valid"].cuda())
            for name, (a, b_, c, bias, dout) in (("row", (rq, rk, rv, rbias, rd)),
                                                 ("plane", (q, k, v, plane, d_out))):
                got = fused_attention(a, b_, c, bias)
                torch.cuda.synchronize()
                line.append(f"dense {name} " + hold(
                    "fused_attention", f"{name} L={L}", got,
                    fused_attention_plain(a, b_, c, bias), dtype, name == "plane"))
                grads = flash_attention_bwd(a, b_, c, bias, dout, want_dbias=True)
                torch.cuda.synchronize()
                want = flash_attention_bwd_plain(a, b_, c, bias, dout)
                line.append(f"backward {name} " + ", ".join(
                    f"{out} " + hold("flash_bwd", f"{out} {name} L={L}", g, w, dtype, True)
                    for out, g, w in zip(("dq", "dk", "dv", "dbias"), grads, want)))
                del got, grads, want
            # a batch row with no valid key, through all three
            masked = attention_case(rng, "masked", 4, 140, L - 140, 4, "chunk")
            masked["vecs"] = (torch.zeros_like(masked["vecs"][0]),) + masked["vecs"][1:]
            mq, mk, mv, *mvecs = cuda_args(masked, dtype)
            got = fused_attention_spec(mq, mk, mv, *mvecs, stage="chunk",
                                       text_len=masked["text_len"])
            hold("spec_attention", f"masked L={L}", got,
                 spec_attention_plain(mq, mk, mv, *mvecs, stage="chunk",
                                      text_len=masked["text_len"]), dtype, False)
            mbias = padding_bias(mvecs[0])
            hold("fused_attention", f"masked L={L}", fused_attention(mq, mk, mv, mbias),
                 fused_attention_plain(mq, mk, mv, mbias), dtype, False)
            for g, w in zip(flash_attention_bwd(mq, mk, mv, mbias, torch.ones_like(mq)),
                            flash_attention_bwd_plain(mq, mk, mv, mbias, torch.ones_like(mq))):
                hold("flash_bwd", f"masked L={L}", g, w, dtype, True)
            line.append("fully masked rows finite and as plain")
            print(f"[13 long keys] Lk {L} {str(dtype):15s} " + " | ".join(line))
            if L == LONG_KEYS[0] and dtype == torch.bfloat16:
                same = [torch.equal(fused_attention_spec(q, k, v, *vecs, stage="chunk",
                                                         text_len=140),
                                    fused_attention_spec(q, k, v, *vecs, stage="chunk",
                                                         text_len=140)),
                        torch.equal(fused_attention(q, k, v, plane),
                                    fused_attention(q, k, v, plane))]
                runs = [flash_attention_bwd(q, k, v, plane, d_out, want_dbias=False)[:3]
                        for _ in range(2)]
                same.append(all(torch.equal(a, b_) for a, b_ in zip(*runs)))
                print(f"[13 long keys] bf16 two launches at Lk {L}: stage-mask, dense "
                      f"forward, backward dq/dk/dv bit-equal {same}")
                check(all(same), "long keys: two bf16 launches differ")
                del runs
            del q, k, v, plane, d_out, rq, rk, rv, rd, rbias
    print(f"[13 long keys] worst |kernel - plain| {worst} (forward tol {TOL}, backward and "
          f"plane-bias tol of max |plain| {BWD_TOL})")

    timed = {k: [] for k in KERNELS}
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for stage in ("full", "chunk"):
        case = attention_case(rng, f"(128, 240, 240, 12, 64) {stage}", 128, 140, 100, 12,
                              stage)
        args = cuda_args(case, dt)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        kernel = lambda: fused_attention_spec(*args, **kw)
        lib = sdpa_call(*args, case)
        b_ms, b_by = bound(case, dt)
        row = dict(shape=case["name"], ms=median_ms(kernel), b2b_ms=back_to_back_ms(kernel),
                   plain_ms=median_ms(lambda: spec_attention_plain(*args, **kw)),
                   library_ms=median_ms(lib), library_b2b_ms=back_to_back_ms(lib),
                   bound_ms=b_ms, bound_by=b_by)
        timed["spec_attention"].append(row)
        del args
    case = dense_case(rng, 128, 230, 10, 16, 64)
    q, k, v, d_out = (case[n].to("cuda", dt) for n in ("q", "k", "v", "d_out"))
    bias = padding_bias(case["valid"].cuda())
    mask = bias.to(dt)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    qt, kt, vt = (t.detach().requires_grad_() for t in (q4, k4, v4))
    out_t = sdpa(qt, kt, vt, attn_mask=mask)
    d_out_t = d_out.transpose(1, 2)
    for name, kind, kernel, plain, lib in (
        ("fused_attention", "forward", lambda: fused_attention(q, k, v, bias),
         lambda: fused_attention_plain(q, k, v, bias),
         lambda: sdpa(q4, k4, v4, attn_mask=mask)),
        ("flash_bwd", "backward",
         lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False),
         lambda: flash_attention_bwd_plain(q, k, v, bias, d_out),
         lambda: torch.autograd.grad(out_t, (qt, kt, vt), d_out_t, retain_graph=True)),
    ):
        b_ms, b_by = train_bound(case, dt, kind)
        timed[name].append(dict(
            shape="(128, 230, 240, 16, 64), bias [B, 1, 1, Lk]", ms=median_ms(kernel),
            b2b_ms=back_to_back_ms(kernel), plain_ms=median_ms(plain),
            library_ms=median_ms(lib), library_b2b_ms=back_to_back_ms(lib), bound_ms=b_ms,
            bound_by=b_by))
    for name, rows in timed.items():
        for r in rows:
            print(f"[13 long keys time] {name:16s} bf16 {r['shape']:44s} per call: kernel "
                  f"{r['ms']:.4f} | plain {r['plain_ms']:.4f} | sdpa {r['library_ms']:.4f} ms; "
                  f"back to back: kernel {r['b2b_ms']:.4f} | sdpa {r['library_b2b_ms']:.4f} ms "
                  f"| bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel at "
                  f"{r['bound_ms'] / r['b2b_ms']:.2%} of it")
    return dict(max_abs_err=worst, timed=timed, largest_lk=max(LONG_KEYS))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(port: int, path: str, body=None, timeout: float = 120.0):
    """(status, JSON reply, seconds) of one request to the local server."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, out = r.status, json.load(r)
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read() or b"{}")
    return code, out, time.perf_counter() - t0


def http_load(port: int, plan, path: str = "/score") -> tuple:
    """Each client of ``plan`` (a list of request bodies per client) sends its
    requests to ``path`` one after another, all clients at once; returns the
    replies as ``plan`` lays them out and the wall seconds from the first
    send to the last reply."""
    replies = [[None] * len(bodies) for bodies in plan]
    barrier = threading.Barrier(len(plan))

    def client(c):
        barrier.wait(timeout=60)
        for r, body in enumerate(plan[c]):
            replies[c][r] = http(port, path, body)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(plan)) as pool:
        list(pool.map(client, range(len(plan))))
    return replies, time.perf_counter() - t0


def load_summary(replies, wall: float, direct: dict, what: str) -> dict:
    """Check every reply of an HTTP load (200, finite logits that agree with
    direct scoring within 2e-2 of max |logit|, the same prediction wherever
    the direct top two logits are more than twice that apart) and sum it up:
    examples/s, p50/p99 request latency."""
    flat = [x for row in replies for x in row]
    codes = sorted({code for code, _, _ in flat})
    check(codes == [200], f"{what}: reply codes {codes}")
    got = {r["example_id"]: np.asarray(r["logits"]) for _, out, _ in flat
           for r in out["results"]}
    check(set(got) == set(direct) and all(np.isfinite(g).all() for g in got.values()),
          f"{what}: {len(got)} finite replies for {len(direct)} examples")
    tol = 2e-2 * max(np.abs(w).max() for w in direct.values())
    err = max(np.abs(got[e] - direct[e]).max() for e in direct)
    decided = [e for e in direct if np.diff(np.sort(direct[e])[-2:])[0] > 2 * tol]
    flipped = [e for e in decided if got[e].argmax() != direct[e].argmax()]
    check(err <= tol and not flipped,
          f"{what}: max |http - direct| {err} (tol {tol}), predictions differ at {flipped}")
    lat = np.asarray([t for _, _, t in flat]) * 1e3
    return dict(examples=len(got), requests=len(flat), wall_s=wall,
                examples_per_s=len(got) / wall, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), max_abs_diff=err, tol=tol,
                predictions_checked=len(decided))


def as_json(ex) -> dict:
    """A request's example as the HTTP body carries it."""
    return {"example_id": ex.example_id, "img_id": ex.img_id, "premise": ex.premise,
            "answer_choices": ex.answer_choices}


def start_serve_command_nowait(tmp: str, pack: str, *flags) -> tuple:
    """``python -m multimodal_context_reasoning_torch.cli.serve`` started on
    a free port over the ``.mcrpack``; returns ``(process, port, log
    path)`` at once (:func:`wait_healthz` waits for it)."""
    port = free_port()
    log_path = os.path.join(tmp, f"serve_{port}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_context_reasoning_torch.cli.serve",
             "--port", str(port), "--img_feat_file", pack, "--compute_dtype", "bfloat16",
             *flags], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return proc, port, log_path


def wait_healthz(proc, port: int, log_path: str, started_at: float) -> float:
    """Poll ``/healthz`` until the command answers; seconds since
    ``started_at``."""
    while True:
        check(proc.poll() is None, "the serve command exited: "
              + open(log_path).read()[-2000:])
        check(time.perf_counter() - started_at < 600, "no /healthz within 600 s")
        try:
            if http(port, "/healthz", timeout=5)[0] == 200:
                return time.perf_counter() - started_at
        except OSError:
            pass
        time.sleep(0.5)


def start_serve_command(tmp: str, pack: str, *flags) -> tuple:
    """``python -m multimodal_context_reasoning_torch.cli.serve`` on a free
    port over the ``.mcrpack``, polled on ``/healthz``; returns ``(process,
    port, log path, seconds to /healthz)``."""
    t0 = time.perf_counter()
    proc, port, log_path = start_serve_command_nowait(tmp, pack, *flags)
    try:
        startup = wait_healthz(proc, port, log_path, t0)
    except BaseException:
        stop_serve_command(proc)
        raise
    return proc, port, log_path, startup


def stop_serve_command(proc) -> bool:
    """SIGTERM, then wait; True if the command exited within 60 s (it is
    killed otherwise)."""
    proc.terminate()
    try:
        proc.wait(timeout=60)
        return True
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return False


def serve_phase(rng) -> dict:
    """Phase 14, the slice's main path: ``python -m
    multimodal_context_reasoning_torch.cli.serve`` as a subprocess at full
    width in bf16, micro-batch 8, loaded by concurrent clients through HTTP
    and held against direct ``ModCRScorer.score`` of the same examples; then
    the same load in-process through ``serve(block=False)`` on the direct
    scorer, with the kernel counts set to 0 before and read after."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.server import serve
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = ModCRConfig().with_dtype("bfloat16")   # the serve command's, alignment on
    sizes = rng.integers(SERVE_EXAMPLES[0], SERVE_EXAMPLES[1] + 1,
                         (SERVE_CLIENTS, SERVE_REQUESTS))
    feats, examples = synthetic_requests(rng, int(sizes.sum()) + SERVE_CLIENTS, cfg,
                                         first=50_000)
    warm_plan = [[{"examples": [as_json(ex)]}] for ex in examples[:SERVE_CLIENTS]]
    it = iter(examples[SERVE_CLIENTS:])
    plan = [[{"examples": [as_json(next(it)) for _ in range(n)]} for n in row]
            for row in sizes]
    measured = examples[SERVE_CLIENTS:]
    tmp = tempfile.mkdtemp(prefix="modcr_serve_")
    pack = os.path.join(tmp, "feats.mcrpack")
    write_pack({k: v.features for k, v in feats.items()}, pack)
    out: dict = {}
    try:
        # 1. the command, a process of its own
        proc, port, log_path, startup = start_serve_command(
            tmp, pack, "--micro_batch", str(SERVE_MICRO_BATCH))
        try:
            http_load(port, warm_plan)
            replies, wall = http_load(port, plan)
            stats = http(port, "/stats")[1]
        finally:
            exited = stop_serve_command(proc)
        check(exited, "the serve command did not exit on SIGTERM")
        started = [ln for ln in open(log_path).read().splitlines() if "serving on" in ln]
        print(f"[14 serve] the command: {started} after {startup:.2f} s (model build, "
              f"kernel load, warm-up) | exit code {proc.returncode} after SIGTERM")

        # 2. direct scoring of the same examples, the same weights (seed 0)
        model = ModCRModel(cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
        scorer = ModCRScorer(cfg, model, *hash_tokenizers(cfg), feats,
                             micro_batch=SERVE_MICRO_BATCH, device="cuda")
        scorer.warm_up()
        # seconds of each score_featurized call (collate, copy, forward and
        # the logits' readback): does the load slow the forward, or idle it?
        calls = []
        score_featurized = scorer.score_featurized

        def timed_score(feats_, ids):
            t = time.perf_counter()
            res = score_featurized(feats_, ids)
            calls.append(time.perf_counter() - t)
            return res

        scorer.score_featurized = timed_score
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = scorer.score(measured)
        torch.cuda.synchronize()
        direct_wall = time.perf_counter() - t0
        direct_calls = calls[:]
        direct = {r["example_id"]: np.asarray(r["logits"]) for r in rows}
        route = stats["routes"]["score"]
        out["http_command"] = dict(load_summary(replies, wall, direct, "serve command"),
                                   startup_s=startup,
                                   forwards=route["device_dispatches"],
                                   mean_dispatch=route["mean_device_batch"])
        out["direct"] = dict(examples=len(rows), wall_s=direct_wall,
                             examples_per_s=len(rows) / direct_wall,
                             forwards=len(direct_calls),
                             ms_per_forward=1e3 * statistics.mean(direct_calls),
                             forward_share=sum(direct_calls) / direct_wall)

        # 3. the same load in-process, counting the kernel launches
        server = serve(scorer, "127.0.0.1", 0, block=False)
        try:
            sport = server.server_address[1]
            http_load(sport, warm_plan)
            before = server.modcr_batcher.telemetry()
            torch.cuda.synchronize()
            del calls[:]
            reset_counts()
            replies, wall = http_load(sport, plan)
            torch.cuda.synchronize()
            launches = read_counts()
            load_calls = calls[:]
            dispatched = server.modcr_batcher.telemetry()[len(before):]
        finally:
            server.modcr_close()
        per_forward = spec_launches_per_eval_forward(cfg)
        out["http_in_process"] = dict(load_summary(replies, wall, direct, "in-process serve"),
                                      forwards=len(dispatched),
                                      mean_dispatch=sum(dispatched) / len(dispatched),
                                      ms_per_forward=1e3 * statistics.mean(load_calls),
                                      forward_share=sum(load_calls) / wall)
        check(launches["spec_attention"] == per_forward * len(dispatched),
              f"serving launches {launches} over {len(dispatched)} forwards, "
              f"{per_forward} stage-mask launches each expected")
        out["launches"] = launches
        out["launches_per_forward"] = per_forward
        del scorer, model
    finally:
        shutil.rmtree(tmp)
    for name in ("http_command", "http_in_process"):
        r = out[name]
        print(f"[14 serve] {name}: {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests of "
              f"{SERVE_EXAMPLES[0]}-{SERVE_EXAMPLES[1]} examples ({r['examples']} examples): "
              f"{r['examples_per_s']:.2f} ex/s over {r['wall_s']:.3f} s | request latency p50 "
              f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms | {r['forwards']} forwards, mean "
              f"dispatch {r['mean_dispatch']:.2f} examples | max |http - direct| "
              f"{r['max_abs_diff']:.3e} (tol {r['tol']:.3e}), {r['predictions_checked']} "
              f"predictions held")
    d, h = out["direct"], out["http_in_process"]
    print(f"[14 serve] direct ModCRScorer.score at micro-batch {SERVE_MICRO_BATCH}, the same "
          f"{d['examples']} examples in order: {d['examples_per_s']:.2f} ex/s "
          f"({d['forwards']} forwards, {d['wall_s']:.3f} s)")
    print(f"[14 serve] score_featurized (collate, copy, forward, readback) per call: direct "
          f"{d['ms_per_forward']:.2f} ms, {d['forward_share']:.1%} of the wall | under the "
          f"in-process HTTP load {h['ms_per_forward']:.2f} ms, {h['forward_share']:.1%} of the "
          f"wall (the rest: the dispatcher waiting for featurized examples)")
    print(f"[14 serve] in-process launches {out['launches']} = {out['launches_per_forward']} "
          f"stage-mask launches x {out['http_in_process']['forwards']} forwards")
    return out


# ---------------------------------------------------------------- int8

def int8_products(rng) -> dict:
    """Phase 15a: ``int8_matmul`` on the card against its plain version at
    the encoders' FFN shape at micro-batch 8 and RoBERTa's at 32: the int32
    accumulators (``torch._int_mm`` against the float64 product of the same
    codes) and the bf16 outputs bit-equal; then, back to back, the int8
    route with the weight quantized once (the scorer's), its code product
    alone and a bf16 ``F.linear`` at the same shape."""
    from multimodal_context_reasoning_torch.ops.quant import (
        int8_matmul,
        int8_mm,
        int8_mm_plain,
        quantize_symmetric,
    )

    out = {}
    for name, (rows, k, n) in INT8_SHAPES.items():
        x, w, b = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)
                   .to("cuda", torch.bfloat16)
                   for shape, scale in (((rows, k), 1.0), ((n, k), 0.03), ((n,), 0.1)))
        xq, _ = quantize_symmetric(x, 1)
        wq, ws = quantize_symmetric(w, 1)
        acc = int8_mm(xq, wq)
        same_acc = torch.equal(acc, int8_mm_plain(xq, wq))
        route = lambda: int8_matmul(x, w, b, torch.bfloat16, weight_q=(wq, ws))
        got = route()
        same_out = torch.equal(got, int8_matmul(x, w, b, torch.bfloat16, plain=True))
        check(same_acc and same_out and torch.isfinite(got).all().item(),
              f"15 int8 {name}: accumulator bit-equal {same_acc}, output bit-equal {same_out}")
        del acc, got
        r = dict(shape=[rows, k, n], accumulator_bit_equal=same_acc, output_bit_equal=same_out,
                 route_b2b_ms=back_to_back_ms(route),
                 int_mm_b2b_ms=back_to_back_ms(lambda: int8_mm(xq, wq)),
                 bf16_linear_b2b_ms=back_to_back_ms(lambda: torch.nn.functional.linear(x, w, b)),
                 plain_ms=median_ms(lambda: int8_matmul(x, w, b, torch.bfloat16, plain=True),
                                    reps=3, warmup=1))
        # least time: codes read and the int32 accumulator written once at HBM
        # rate, or the products at the int8 peak; bf16: inputs and output
        int8_bytes, bf16_bytes = rows * k + n * k + 4 * rows * n, 2 * (rows * k + n * k + rows * n)
        r["int_mm_bound_ms"] = 1e3 * max(int8_bytes / HBM_BYTES_PER_S, 2.0 * rows * k * n / INT8_PEAK)
        r["bf16_bound_ms"] = 1e3 * max(bf16_bytes / HBM_BYTES_PER_S,
                                       2.0 * rows * k * n / PEAK_FLOPS[torch.bfloat16])
        out[name] = r
        print(f"[15 int8] {name} {rows} x {k} · {k} x {n}: accumulator bit-equal {same_acc}, "
              f"output bit-equal {same_out} | back to back: int8 route (activations quantized, "
              f"codes multiplied, rescaled) {r['route_b2b_ms']:.4f} ms, torch._int_mm alone "
              f"{r['int_mm_b2b_ms']:.4f} ms (bound {r['int_mm_bound_ms']:.4f}), bf16 linear "
              f"{r['bf16_linear_b2b_ms']:.4f} ms (bound {r['bf16_bound_ms']:.4f}) | plain "
              f"{r['plain_ms']:.2f} ms")
        del x, w, b, xq, wq
        torch.cuda.empty_cache()
    return out


def int8_scoring(rng) -> dict:
    """Phase 15b: full-width bf16 ``ModCRScorer`` (alignment off) with and
    without ``with_quantize("int8")`` on one set of weights, at micro-batch 8
    and 32, timed in turns (bf16, int8, int8, bf16) over the same requests;
    every int8 forward must launch the stage-mask kernel exactly 60 times."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = dataclasses.replace(ModCRConfig(), compute_alignment=False).with_dtype("bfloat16")
    weights = ModCRModel(cfg, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED)).state_dict()
    tok = hash_tokenizers(cfg)
    out, launches = {}, 0
    for mb, n_chunks in zip(MICRO_BATCHES, (8, 4)):
        feats, reqs = synthetic_requests(rng, mb * (n_chunks + 1), cfg, first=60_000 + 1000 * mb)
        scorers = {name: ModCRScorer(c, weights, *tok, feats, micro_batch=mb, device="cuda")
                   for name, c in (("bf16", cfg), ("int8", cfg.with_quantize("int8")))}
        for sc in scorers.values():
            sc.score(reqs[:mb])                       # warm-up micro-batch
        walls, rows = {"bf16": [], "int8": []}, {}
        for name in ("bf16", "int8", "int8", "bf16"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            rows[name] = scorers[name].score(reqs[mb:])
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if name == "int8":
                n = read_counts()["spec_attention"]
                check(n == LAUNCHES_PER_FORWARD * n_chunks,
                      f"15 int8 mb {mb}: {n} stage-mask launches over {n_chunks} forwards")
                launches += n
        logits = {k: np.asarray([r["logits"] for r in v]) for k, v in rows.items()}
        check(np.isfinite(logits["int8"]).all(), f"15 int8 mb {mb}: non-finite logits")
        agree = int((logits["int8"].argmax(1) == logits["bf16"].argmax(1)).sum())
        r = dict(examples=len(rows["int8"]),
                 bf16_examples_per_s=[len(rows["bf16"]) / t for t in walls["bf16"]],
                 int8_examples_per_s=[len(rows["int8"]) / t for t in walls["int8"]],
                 max_abs_dlogit=float(np.abs(logits["int8"] - logits["bf16"]).max()),
                 max_abs_logit=float(np.abs(logits["bf16"]).max()), decisions_agree=agree,
                 launches_per_forward=LAUNCHES_PER_FORWARD)
        out[mb] = r
        print(f"[15 int8] scorer micro_batch {mb}, {r['examples']} examples in turns: bf16 "
              + ", ".join(f"{v:.2f}" for v in r["bf16_examples_per_s"]) + " ex/s | int8 "
              + ", ".join(f"{v:.2f}" for v in r["int8_examples_per_s"])
              + f" ex/s | max |int8 - bf16| logit {r['max_abs_dlogit']:.4e} (max |logit| "
              f"{r['max_abs_logit']:.4f}) | 4-way decisions agree {agree}/{r['examples']} | "
              f"{LAUNCHES_PER_FORWARD} stage-mask launches per int8 forward")
        del scorers
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def int8_command(rng) -> dict:
    """Phase 15c: one /score request to ``cli.serve --quantize int8`` (full
    width, bf16, alignment on, micro-batch 8, seeded random init), held
    against direct int8 scoring of the same examples on the same weights."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = ModCRConfig().with_dtype("bfloat16").with_quantize("int8")
    feats, examples = synthetic_requests(rng, 3, cfg, first=70_000)
    tmp = tempfile.mkdtemp(prefix="modcr_int8_")
    try:
        pack = os.path.join(tmp, "feats.mcrpack")
        write_pack({k: v.features for k, v in feats.items()}, pack)
        proc, port, log_path, startup = start_serve_command(
            tmp, pack, "--micro_batch", str(SERVE_MICRO_BATCH), "--quantize", "int8")
        try:
            code, reply, seconds = http(port, "/score",
                                        {"examples": [as_json(ex) for ex in examples]})
        finally:
            exited = stop_serve_command(proc)
        started = [ln for ln in open(log_path).read().splitlines() if "serving on" in ln]
    finally:
        shutil.rmtree(tmp)
    check(exited and code == 200, f"15c the int8 command: reply {code}, exited {exited}")
    model = ModCRModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    direct = {r["example_id"]: np.asarray(r["logits"]) for r in ModCRScorer(
        cfg, model, *hash_tokenizers(cfg), feats, micro_batch=SERVE_MICRO_BATCH,
        device="cuda").score(examples)}
    r = load_summary([[(code, reply, seconds)]], seconds, direct, "15c int8 command")
    print(f"[15 int8] the command --quantize int8: {started} after {startup:.2f} s | one "
          f"request of {len(examples)} examples: {code} in {1e3 * seconds:.1f} ms | max |http - "
          f"direct int8| {r['max_abs_diff']:.3e} (tol {r['tol']:.3e})")
    del model
    torch.cuda.empty_cache()
    return dict(startup_s=startup, request_ms=1e3 * seconds, max_abs_diff=r["max_abs_diff"])


# ---------------------------------------------------------------- /generate

def generate_launches_per_forward(enc) -> int:
    """Stage-mask launches of one classify forward of the rationale family:
    every layer of both encoders (its cross-stage layers return no
    probabilities): 12 + 12 = 24 at full width."""
    return 2 * enc.num_hidden_layers


def generation_parity(rng, cfg, spec, tok) -> dict:
    """Phase 16a: one question at fp32 on the card and on the CPU from one
    seeded full-width rationale model: choice probabilities and the decoder
    memory, then the decoder's teacher-forced logits over the CPU's greedy
    tokens (both devices from the same inputs), and how many greedy tokens
    agree."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
    )
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_requests

    enc, sched, gpt = EncoderConfig(), ChunkAlignConfig(), GPT2Config()
    model = RationaleModel(enc, sched, gpt, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED))
    cpu_model = copy.deepcopy(model).cpu()
    feats, qs = synthetic_requests(rng, 1, cfg, first=80_000)
    gens = {dev: RationaleGenerator(enc, sched, gpt, m, tok[0], tok[1], feats, spec=spec,
                                    micro_batch=1, max_rationale_len=GEN_MAX_LEN, warm=False,
                                    device=dev)
            for dev, m in (("cuda", model), ("cpu", cpu_model))}
    outs, toks = {}, {}
    t0 = time.perf_counter()
    for dev, g in gens.items():
        with torch.inference_mode():
            outs[dev] = g.model(g.device_batch([g.featurize(qs[0])]))
            toks[dev] = g.decode(outs[dev])[0][0].cpu()
    cpu_s = time.perf_counter() - t0
    probs_err = (outs["cuda"].mp_probs.cpu() - outs["cpu"].mp_probs).abs().max().item()
    mem_err = (outs["cuda"].decoder_memory.cpu() - outs["cpu"].decoder_memory).abs().max().item()
    mem_max = outs["cpu"].decoder_memory.abs().max().item()
    # teacher forcing: <|b_rtnl|> + the CPU's tokens through each decoder
    seq = torch.cat([torch.tensor([gens["cpu"].b_rtnl]), toks["cpu"][:-1]])[None]
    logits = {}
    for dev, g in gens.items():
        with torch.inference_mode():
            o = outs["cpu"]
            logits[dev] = g.model.dec(seq.to(dev), memory=o.decoder_memory.float().to(dev),
                                      memory_mask=o.decoder_memory_mask.to(dev))[0].cpu()
    logit_err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    logit_max = logits["cpu"].abs().max().item()
    same = int((toks["cuda"] == toks["cpu"]).cumprod(0).sum())
    r = dict(mp_probs_max_abs_diff=probs_err, memory_max_abs_diff=mem_err,
             memory_max_abs=mem_max, teacher_forced_logits_max_abs_diff=logit_err,
             logits_max_abs=logit_max, greedy_tokens_agree=same, max_len=GEN_MAX_LEN,
             cpu_and_card_s=cpu_s)
    print(f"[16 generate] fp32 card vs CPU, one question: mp_probs max|diff| {probs_err:.3e} "
          f"(tol 1e-4) | decoder memory {mem_err:.3e} (tol 1e-3, max |memory| {mem_max:.2f}) | "
          f"teacher-forced logits over the CPU's greedy tokens {logit_err:.3e} (tol 1e-3, max "
          f"|logit| {logit_max:.3f}) | greedy tokens agree for the first {same}/{GEN_MAX_LEN} "
          f"(not a check: random-init logits have near ties)")
    check(probs_err <= 1e-4 and mem_err <= 1e-3 and logit_err <= 1e-3,
          "16a: the card and the CPU disagree")
    del gens, model, cpu_model, outs
    torch.cuda.empty_cache()
    return r


def generation_summary(replies, wall: float, direct: dict, what: str) -> dict:
    """Check every /generate reply of an HTTP load against direct
    ``RationaleGenerator.generate`` of the same questions (200, the same
    prediction and rationale ids, probabilities within 2e-2) and sum it up."""
    flat = [x for row in replies for x in row]
    codes = sorted({code for code, _, _ in flat})
    check(codes == [200], f"{what}: reply codes {codes}")
    got = {r["example_id"]: r for _, out, _ in flat for r in out["results"]}
    check(set(got) == set(direct), f"{what}: {len(got)} replies for {len(direct)} questions")
    err = max(np.abs(np.subtract(got[q]["probs"], direct[q]["probs"])).max() for q in direct)
    differ = [q for q in direct if (got[q]["rationale_ids"], got[q]["prediction"])
              != (direct[q]["rationale_ids"], direct[q]["prediction"])]
    check(err <= 2e-2 and not differ,
          f"{what}: max |probs - direct| {err}, rationale or prediction differs at {differ}")
    lat = np.asarray([t for _, _, t in flat]) * 1e3
    return dict(questions=len(got), requests=len(flat), wall_s=wall,
                questions_per_s=len(got) / wall, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), max_abs_diff_probs=err)


def generate_phase(rng) -> dict:
    """Phase 16, /generate: the rationale family at full width
    (``EncoderConfig()`` and ``GPT2Config()``, bf16 encoders, fp32 decoder,
    seeded random init, micro-batch 4 questions, 32 decode steps): (a) fp32
    card against CPU; (b) in-process ``serve(generator=...)`` with the kernel
    counts set to 0 before and read after, then ``cli.serve --generate`` in
    its own process, each under concurrent clients, replies held against
    direct ``RationaleGenerator.generate``; the classify forward and the
    decode of one micro-batch timed with CUDA events; (c) ``mode="sample"``
    once: a fixed seed repeats and every token lies in the filter's kept
    set."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
        ModCRConfig,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.generation.decode import (
        sample_decode,
        top_k_top_p_filter,
    )
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.server import serve
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = ModCRConfig().with_dtype("bfloat16")     # the serve command's scorer and batch
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=cfg.global_encoder.img_feature_dim)
    enc, sched, gpt = EncoderConfig(dtype="bfloat16"), ChunkAlignConfig(), GPT2Config()
    bert, rob = hash_tokenizers(cfg)
    gpt_tok = HashTokenizer(vocab_size=gpt.vocab_size)
    out = {"parity": generation_parity(rng, cfg, spec, (bert, gpt_tok))}

    # (b) serving: the command's weights (seed 0 on the card), in-process first
    sizes = rng.integers(GEN_QUESTIONS[0], GEN_QUESTIONS[1] + 1, (GEN_CLIENTS, GEN_REQUESTS))
    feats, qs = synthetic_requests(rng, int(sizes.sum()) + GEN_CLIENTS, cfg, first=90_000)
    warm_plan = [[{"examples": [as_json(q)]}] for q in qs[:GEN_CLIENTS]]
    it = iter(qs[GEN_CLIENTS:])
    plan = [[{"examples": [as_json(next(it)) for _ in range(n)]} for n in row] for row in sizes]
    measured = qs[GEN_CLIENTS:]
    model = RationaleModel(enc, sched, gpt, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    gen = RationaleGenerator(enc, sched, gpt, model, bert, gpt_tok, feats, spec=spec,
                             micro_batch=GEN_MICRO_BATCH, max_rationale_len=GEN_MAX_LEN,
                             device="cuda")
    direct = {r["example_id"]: r for r in gen.generate(measured)}
    # one micro-batch: the classify forward, then the decode (prefill + steps)
    batch = gen.device_batch([gen.featurize(q) for q in measured[:GEN_MICRO_BATCH]])
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fwd_ms, dec_ms = [], []
    for _ in range(3):
        with torch.inference_mode():
            events[0].record()
            o = gen.model(batch)
            events[1].record()
            gen.decode(o)
            events[2].record()
        events[2].synchronize()
        fwd_ms.append(events[0].elapsed_time(events[1]))
        dec_ms.append(events[1].elapsed_time(events[2]))
    timing = dict(classify_ms=statistics.median(fwd_ms), decode_ms=statistics.median(dec_ms),
                  ms_per_decode_step=statistics.median(dec_ms) / (GEN_MAX_LEN + 1))
    scorer = ModCRScorer(cfg, ModCRModel(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)), bert, rob, feats, micro_batch=SERVE_MICRO_BATCH,
        device="cuda")
    server = serve(scorer, "127.0.0.1", 0, block=False, generator=gen)
    try:
        sport = server.server_address[1]
        http_load(sport, warm_plan, "/generate")
        before = server.modcr_gen_batcher.telemetry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        replies, wall = http_load(sport, plan, "/generate")
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        dispatched = server.modcr_gen_batcher.telemetry()[len(before):]
        stats = http(sport, "/stats")[1]
    finally:
        server.modcr_close()
    per_forward = generate_launches_per_forward(enc)
    check(launches["spec_attention"] == per_forward * len(dispatched),
          f"16 /generate launches {launches} over {len(dispatched)} classify forwards, "
          f"{per_forward} each expected")
    check(set(stats["routes"]) >= {"generate"}, f"16 /stats routes {stats.get('routes')}")
    out["in_process"] = dict(generation_summary(replies, wall, direct, "in-process /generate"),
                             forwards=len(dispatched),
                             mean_dispatch=sum(dispatched) / len(dispatched),
                             launches_per_forward=per_forward, peak_gib=peak, **timing)
    out["launches"] = launches["spec_attention"]
    del scorer, server
    torch.cuda.empty_cache()

    # the command, a process of its own, with the same weights
    tmp = tempfile.mkdtemp(prefix="modcr_generate_")
    try:
        pack = os.path.join(tmp, "feats.mcrpack")
        write_pack({k: v.features for k, v in feats.items()}, pack)
        proc, port, log_path, startup = start_serve_command(
            tmp, pack, "--micro_batch", str(SERVE_MICRO_BATCH), "--generate",
            "--gen_micro_batch", str(GEN_MICRO_BATCH), "--max_rationale_len", str(GEN_MAX_LEN))
        try:
            http_load(port, warm_plan, "/generate")
            replies, wall = http_load(port, plan, "/generate")
            route = http(port, "/stats")[1]["routes"]["generate"]
        finally:
            exited = stop_serve_command(proc)
        started = [ln for ln in open(log_path).read().splitlines() if "serving on" in ln]
    finally:
        shutil.rmtree(tmp)
    check(exited, "the serve --generate command did not exit on SIGTERM")
    out["command"] = dict(generation_summary(replies, wall, direct, "serve --generate command"),
                          startup_s=startup, forwards=route["device_dispatches"],
                          mean_dispatch=route["mean_device_batch"])
    print(f"[16 generate] the command: {started} after {startup:.2f} s (both models built "
          f"and warmed)")
    for name in ("in_process", "command"):
        r = out[name]
        print(f"[16 generate] {name}: {GEN_CLIENTS} clients x {GEN_REQUESTS} requests of "
              f"{GEN_QUESTIONS[0]}-{GEN_QUESTIONS[1]} questions ({r['questions']} questions): "
              f"{r['questions_per_s']:.2f} questions/s over {r['wall_s']:.3f} s | request "
              f"latency p50 {r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms | {r['forwards']} "
              f"forwards, mean dispatch {r['mean_dispatch']:.2f} questions | replies = direct "
              f"generate (max |probs diff| {r['max_abs_diff_probs']:.2e})")
    r = out["in_process"]
    print(f"[16 generate] one micro-batch of {GEN_MICRO_BATCH} questions: classify forward "
          f"{r['classify_ms']:.2f} ms, decode {r['decode_ms']:.2f} ms = {r['ms_per_decode_step']:.3f}"
          f" ms per decoder call ({GEN_MAX_LEN} steps + prefill) | stage-mask launches "
          f"{out['launches']} = {per_forward} x {r['forwards']} classify forwards | peak "
          f"{r['peak_gib']:.2f} GiB under the load")

    # (c) sampling once: a fixed seed repeats; every token in the kept set
    kw = dict(top_k=40, top_p=0.9, temperature=0.8)
    with torch.inference_mode():
        o = gen.model(batch)
        prompt = torch.full((GEN_MICRO_BATCH, 1), gen.b_rtnl, device="cuda")
        plen = torch.ones(GEN_MICRO_BATCH, dtype=torch.long, device="cuda")
        mem, mmask = o.decoder_memory.float(), o.decoder_memory_mask
        draws = [sample_decode(gen.model.dec, prompt, plen, memory=mem, memory_mask=mmask,
                               generator=torch.Generator(device="cuda").manual_seed(s),
                               max_len=GEN_MAX_LEN, eos_id=gen.e_rtnl,
                               pad_id=gpt.pad_token_id, **kw) for s in (5, 5, 6)]
        toks, lens = draws[0]
        logits, _ = gen.model.dec(torch.cat([prompt, toks[:, :-1]], 1), memory=mem,
                                  memory_mask=mmask)
        kept = top_k_top_p_filter(logits.float() / kw["temperature"], kw["top_k"],
                                  kw["top_p"]) > -1e8
    active = torch.arange(GEN_MAX_LEN, device="cuda")[None] < lens[:, None]
    in_set = kept.gather(-1, toks[..., None])[..., 0] | ~active
    repeats = all(torch.equal(a, b) for a, b in zip(draws[0], draws[1]))
    differs = not torch.equal(draws[0][0], draws[2][0])
    check(repeats and bool(in_set.all()), f"16c sampling: repeats {repeats}, "
          f"{int((~in_set).sum())} tokens outside the kept set")
    out["sample"] = dict(repeats=repeats, other_seed_differs=differs,
                         tokens_checked=int(active.sum()), **kw)
    print(f"[16 generate] mode=sample {kw}: seed 5 twice equal {repeats}, seed 6 differs "
          f"{differs} | all {int(active.sum())} sampled tokens in the top-k/top-p kept set "
          f"of their teacher-forced logits")
    del gen, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- beam and CBS

def constraint_tokens(bert, example, ids) -> list:
    """The BERT token strings of one candidate row's ids (positions 1..T-1),
    named through the in-tree tokenizer from the question's own text; ids it
    cannot name (padding, specials) keep a bracketed name, which the
    constraint extraction drops."""
    text = " ".join([example.premise] + list(example.answer_choices))
    words = bert.tokenize(text)
    names = dict(zip(bert.convert_tokens_to_ids(words), words))
    names.update({0: "[PAD]", 1: "[CLS]", 2: "[SEP]", 3: "<mask>"})
    return [names.get(int(i), "[UNK]") for i in ids]


def synthetic_detections(rng, n_boxes: int = 8):
    """Detections of one image: boxes, Open-Images-style class names (some
    blacklisted, some zero-score padding) and confidences."""
    names = [str(rng.choice(DETECTION_CLASSES)) for _ in range(n_boxes)]
    xy = rng.integers(0, 500, size=(n_boxes, 2)).astype(float)
    boxes = np.concatenate([xy, xy + rng.integers(20, 200, size=(n_boxes, 2))], axis=1)
    scores = rng.uniform(0.3, 1.0, n_boxes)
    scores[-1] = 0.0
    return boxes, names, scores


def cbs_lattices(rng, n: int, gpt_tok, vocab_size: int):
    """``n`` questions' detections -> ConstraintFilter -> constraint ids ->
    FSM adjacency [n, S, S, V] (bool) and the constraint counts."""
    from multimodal_context_reasoning_torch.generation import (
        ClassHierarchy,
        ConstraintFilter,
        FiniteStateMachineBuilder,
        boxes_to_constraint_ids,
    )

    filt = ConstraintFilter(ClassHierarchy(DETECTION_HIERARCHY), 0.85, CBS_CONSTRAINTS)
    builder = FiniteStateMachineBuilder(vocab_size, CBS_CONSTRAINTS, CBS_WORDS)
    adjacency, counts, chosen = [], [], []
    while len(adjacency) < n:
        names, ids = boxes_to_constraint_ids(*synthetic_detections(rng), filt,
                                             gpt_tok.convert_tokens_to_ids,
                                             wordforms=DETECTION_WORDFORMS)
        if len(names) < CBS_CONSTRAINTS:
            continue
        adjacency.append(builder.build(ids).adjacency)
        counts.append(len(names))
        chosen.append((names, ids))
    return torch.from_numpy(np.stack(adjacency)).bool(), torch.tensor(counts), chosen


def device_profile(fn) -> tuple:
    """The summed device time (ms) and the count of the CUDA kernels of one
    ``fn()`` under ``torch.profiler`` (every kernel, the library's too)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def timed_decode(decoder, fn) -> dict:
    """Run ``fn`` (one decode) with CUDA events around it and a counter on
    the decoder's calls; peak memory from a reset, and the part of it above
    what was allocated when the decode began (the model, the memory, what
    earlier phases still hold)."""
    calls = []
    hook = decoder.register_forward_hook(lambda *_: calls.append(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    finally:
        hook.remove()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    return dict(out=out, ms=ms, calls=len(calls), ms_per_call=ms / len(calls),
                peak_gib=peak / 2**30, peak_above_start_gib=(peak - before) / 2**30)


def beam_cbs_phase(rng) -> dict:
    """Phase 17: the classify forward, attention-derived constraints, beam
    sampling and CBS at full width (bf16 encoders, fp32 GPT-2), with the
    kernel counts set to 0 before the path and read after it."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
        ModCRConfig,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.generation import extract_constraints
    from multimodal_context_reasoning_torch.generation.api import generate
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = ModCRConfig().with_dtype("bfloat16")
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=cfg.global_encoder.img_feature_dim)
    enc, sched, gpt = EncoderConfig(dtype="bfloat16"), ChunkAlignConfig(), GPT2Config()
    bert, _ = hash_tokenizers(cfg)
    gpt_tok = HashTokenizer(vocab_size=gpt.vocab_size)
    Q = BEAM_QUESTIONS
    model = RationaleModel(enc, sched, gpt, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 17))
    feats, qs = synthetic_requests(rng, Q, cfg, first=100_000)
    gen = RationaleGenerator(enc, sched, gpt, model, bert, gpt_tok, feats, spec=spec,
                             micro_batch=Q, max_rationale_len=BEAM_MAX_LEN, warm=False,
                             device="cuda")
    batch = gen.device_batch([gen.featurize(q) for q in qs])
    adjacency, counts, chosen = cbs_lattices(rng, Q, gpt_tok, gpt.vocab_size)
    adjacency, counts = adjacency.cuda(), counts.cuda()
    encode = lambda s: gpt_tok.convert_tokens_to_ids(gpt_tok.tokenize(s))
    prompt = torch.full((Q, 1), gen.b_rtnl, device="cuda")
    plen = torch.ones(Q, dtype=torch.long, device="cuda")
    dec = gen.model.dec

    with torch.inference_mode():   # warm-up: the first calls load libraries
        warm = gen.model(batch)
        for mode, n in (("beam", 4), ("cbs", 3)):
            generate(dec, prompt, plen, mode=mode, max_len=n, memory=warm.decoder_memory.float(),
                     memory_mask=warm.decoder_memory_mask, eos_id=gen.e_rtnl,
                     generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
                     fsm_adjacency=adjacency, num_constraints=counts)
        del warm
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = gen.model(batch)
        end.record()
        end.synchronize()
        classify_ms = start.elapsed_time(end)
        gold = out.mp_probs.argmax(dim=-1)
        rows = torch.arange(Q, device="cuda") * 4 + gold
        ids = batch["input_ids"][rows, 1:].cpu().numpy()
        attn = out.cls_attn[rows].float().cpu().numpy()
        tokens = [constraint_tokens(bert, qs[i], ids[i]) * 3 for i in range(Q)]
        cmask = torch.from_numpy(extract_constraints(tokens, attn, encode, gpt.vocab_size))
        mem, mmask = out.decoder_memory.float(), out.decoder_memory_mask
        common = dict(memory=mem, memory_mask=mmask, eos_id=gen.e_rtnl, pad_id=gpt.pad_token_id,
                      num_beams=BEAM_WIDTH)
        beam = lambda: generate(dec, prompt, plen, mode="beam", max_len=BEAM_MAX_LEN, top_k=50,
                                constraint_mask=cmask.cuda(),
                                generator=torch.Generator(device="cuda").manual_seed(SEED),
                                **common)
        cbs = lambda: generate(dec, prompt, plen, mode="cbs", max_len=CBS_MAX_LEN,
                               fsm_adjacency=adjacency, num_constraints=counts,
                               min_constraints_to_satisfy=2, **common)
        runs = {"beam": timed_decode(dec, beam), "cbs": timed_decode(dec, cbs)}
    torch.cuda.synchronize()
    launches = read_counts()
    per_forward = generate_launches_per_forward(enc)
    check(launches == {"spec_attention": per_forward, "fused_attention": 0, "flash_bwd": 0},
          f"17 launches over one classify forward, beam and CBS: {launches}")

    result = dict(questions=Q, classify_ms=classify_ms, launches=launches,
                  constraint_words_per_question=int(cmask.sum(1).float().mean()))
    for mode, r in runs.items():
        toks, lens = (t.cpu() for t in r.pop("out"))
        max_len = BEAM_MAX_LEN if mode == "beam" else CBS_MAX_LEN
        check(tuple(toks.shape) == (Q, max_len) and bool(((lens >= 1) & (lens <= max_len)).all())
              and bool(((toks >= 0) & (toks < gpt.vocab_size)).all()),
              f"17 {mode}: tokens {tuple(toks.shape)}, lengths {lens.tolist()}")
        r["kernels_per_call"] = device_profile(beam if mode == "beam" else cbs)[1] / r["calls"]
        r["questions_per_s"] = Q / (r["ms"] / 1e3)
        r["lengths"] = lens.tolist()
        if mode == "cbs":
            # the chosen beam carries a wordform of at least 2 of its 3
            # single-word constraints (the popcount rule of the selection)
            met = [sum(any(w in toks[i].tolist() for w in c[0]) for c in chosen[i][1])
                   for i in range(Q)]
            check(min(met) >= 2, f"17 cbs: constraints met per question {met}")
            r["constraints_met"] = met
            r["constraints"] = [c[0] for c in chosen]
        result[mode] = r
        print(f"[17 beam/cbs] {mode}: {Q} questions, {r['calls']} decoder calls "
              f"(prefill + steps), {r['ms']:.2f} ms per decode = {r['ms_per_call']:.3f} ms per "
              f"decoder call, {r['questions_per_s']:.2f} questions/s (decode alone), "
              f"{r['kernels_per_call']:.1f} device kernels per decoder call (torch.profiler), "
              f"peak {r['peak_gib']:.2f} GiB ({r['peak_above_start_gib']:.2f} above the start) | "
              f"lengths {r['lengths']}"
              + (f" | constraints {r['constraints']} met {r['constraints_met']}"
                 if mode == "cbs" else ""))
    print(f"[17 beam/cbs] classify forward {classify_ms:.2f} ms, {per_forward} stage-mask "
          f"launches (counts over the whole path: {launches}) | "
          f"{result['constraint_words_per_question']} constraint ids a question on average")
    del gen, model, out, mem, adjacency
    torch.cuda.empty_cache()
    result["parity"] = beam_cbs_parity(rng)
    return result


def beam_cbs_parity(rng) -> dict:
    """Phase 17a: beam and CBS on the card and on the CPU in fp32, from one
    seeded full-width GPT-2 of BEAM_PARITY_LAYERS layers, one memory and one
    set of lattices: CBS tokens identical and its lattice log-probabilities
    within 1e-4 + 1e-5·|lp|; beam tokens and lengths identical with the same
    replayed noise, and the log-probabilities of the chosen tokens (teacher
    forced) within the same bound."""
    from multimodal_context_reasoning_torch.core.config import GPT2Config
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.generation.beam import (
        constrained_beam_sample,
        gumbel_noise,
    )
    from multimodal_context_reasoning_torch.generation.fsm import fsm_decode_gpt2
    from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder

    gpt = GPT2Config(n_layer=BEAM_PARITY_LAYERS)
    Q, M, V = BEAM_PARITY_QUESTIONS, 417, gpt.vocab_size
    card = GPT2Decoder(gpt).cuda().eval()
    card.init_weights(torch.Generator(device="cuda").manual_seed(SEED + 171))
    cpu = copy.deepcopy(card).cpu()
    mem = torch.from_numpy(rng.standard_normal((Q, M, gpt.n_embd), dtype=np.float32))
    mmask = torch.ones(Q, M)
    mmask[1, 300:] = 0.0
    prompt = torch.from_numpy(rng.integers(0, V, (Q, 3))).long()
    plen = torch.tensor([3, 2])
    adjacency, _, _ = cbs_lattices(rng, Q, HashTokenizer(vocab_size=V), V)
    noise = gumbel_noise((BEAM_PARITY_STEPS, Q, BEAM_WIDTH * V), torch.Generator().manual_seed(5),
                         "cpu")
    outs, t0 = {}, time.perf_counter()
    for dev, m in (("cuda", card), ("cpu", cpu)):
        args = (prompt.to(dev), plen.to(dev))
        kw = dict(memory=mem.to(dev), memory_mask=mmask.to(dev), num_beams=BEAM_WIDTH)
        lattice = fsm_decode_gpt2(m, *args, adjacency.to(dev), max_steps=CBS_PARITY_STEPS,
                                  eos_ids=(V - 1,), **kw)
        beam = constrained_beam_sample(m, *args, max_steps=BEAM_PARITY_STEPS, eos_id=V - 1,
                                       noise=noise, top_k=50, **kw)
        with torch.no_grad():
            seq = torch.cat([args[0][:, :1], beam[0]], 1)
            logp = torch.log_softmax(m(seq, memory=kw["memory"],
                                       memory_mask=kw["memory_mask"])[0][:, :-1].float(), -1)
            chosen = logp.gather(-1, beam[0][..., None])[..., 0]
        outs[dev] = [t.cpu() for t in (*lattice, *beam, chosen)]
    seconds = time.perf_counter() - t0
    (cb, clp, bt, bl, bc), (xb, xlp, xt, xl, xc) = outs["cuda"], outs["cpu"]
    lp_err = ((clp - xlp).abs() - 1e-5 * xlp.abs()).max().item()
    chosen_err = ((bc - xc).abs() - 1e-5 * xc.abs()).max().item()
    r = dict(cbs_tokens_equal=bool(torch.equal(cb, xb)),
             beam_tokens_equal=bool(torch.equal(bt, xt) and torch.equal(bl, xl)),
             cbs_logp_excess=lp_err, chosen_logp_excess=chosen_err, seconds=seconds,
             layers=BEAM_PARITY_LAYERS)
    print(f"[17a beam/cbs parity] fp32, {BEAM_PARITY_LAYERS}-layer full-width GPT-2, {Q} "
          f"questions: CBS ({CBS_PARITY_STEPS} steps, S={adjacency.shape[1]}) tokens equal "
          f"{r['cbs_tokens_equal']}, max(|Δlp| - 1e-5·|lp|) {lp_err:.2e} (tol 1e-4) | beam "
          f"({BEAM_PARITY_STEPS} steps, replayed noise) tokens and lengths equal "
          f"{r['beam_tokens_equal']}, chosen-token log-probs max(|Δ| - 1e-5·|lp|) "
          f"{chosen_err:.2e} (tol 1e-4) | card + CPU {seconds:.1f} s")
    check(r["cbs_tokens_equal"] and r["beam_tokens_equal"] and lp_err <= 1e-4
          and chosen_err <= 1e-4, "17a: the card and the CPU disagree")
    del card, cpu
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------- rationale training

class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def rationale_batches(rng, n: int, questions: int, cfg, spec, bert, gpt, gpt_tok) -> list:
    """``n`` training batches of ``questions`` questions each: the collated
    candidate rows (the serving generator's VCR featurizer), the binary
    label of each row, and one explanation stream per question (random words
    from the synthetic objects)."""
    from multimodal_context_reasoning_torch.data.collate import collate_candidates
    from multimodal_context_reasoning_torch.data.rationale import (
        RationaleSpec,
        collate_rationales,
    )
    from multimodal_context_reasoning_torch.data.vcr import VCRDataset
    from multimodal_context_reasoning_torch.serving.synthetic import (
        OBJECTS,
        synthetic_requests,
    )

    keys = ("input_ids", "token_type_ids", "text_mask", "gather_index", "img_feat", "img_mask")
    words = OBJECTS + ("the", "is", "near", "because")
    out = []
    for i in range(n):
        feats, qs = synthetic_requests(rng, questions, cfg, first=200_000 + 1000 * i)
        ds = VCRDataset([], feats, bert, gpt_tok, spec=spec, max_chunks=40)
        b = collate_candidates([ds.featurize(q) for q in qs], [ds.get_image(q) for q in qs],
                               spec)
        batch = {k: b[k] for k in keys}
        label = np.zeros((questions, 4), np.int32)
        label[np.arange(questions), rng.integers(0, 4, questions)] = 1
        batch["label"] = label.reshape(-1)
        texts = [" ".join(rng.choice(words, int(rng.integers(6, 20)))) for _ in range(questions)]
        batch.update(collate_rationales(texts, gpt_tok, RationaleSpec(
            max_len=RATIONALE_LEN, pad_id=gpt.pad_token_id)))
        batch["example_mask"] = np.ones((questions,), np.float32)
        out.append(batch)
    return out


def exact_backward(q, k, v, bias, d_out):
    """The attention backward in float64 with nothing rounded: the yardstick
    that tells the kernel's and the plain version's bf16 roundings apart."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, d_out))
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if bias is not None:
        s = s + bias.double()
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd), torch.einsum("bhqk,bqhd->bkhd", ds, qd),
            torch.einsum("bhqk,bqhd->bkhd", p, dod))


class HeldBackward:
    """While active, every backward launch is held against its plain version
    on the same inputs and both against the float64 backward: per (shape,
    bias shape) the launches and the worst errors of dq, dk and dv, each
    relative to that output's max |exact|: kernel against plain, kernel
    against exact and plain against exact."""

    def __init__(self, keep: bool = False):
        self.seen = {}
        self.keep = keep
        self.inputs = {}   # with keep: the first (q, k, v, bias, dO) of each key

    def __enter__(self):
        from multimodal_context_reasoning_torch.ops.flash import (
            flash_attention_bwd,
            flash_attention_bwd_plain,
        )

        launch = flash_attention_bwd.launch

        def held(q, k, v, bias, d_out, *, want_dbias=True):
            key = (tuple(q.shape), str(q.dtype), None if bias is None else tuple(bias.shape))
            if self.keep and key not in self.inputs:
                self.inputs[key] = tuple(t.detach() for t in (q, k, v, bias, d_out))
            got = launch(q, k, v, bias, d_out, want_dbias=want_dbias)
            want = flash_attention_bwd_plain(q, k, v, bias, d_out)
            exact = exact_backward(q, k, v, bias, d_out)
            rel = lambda a, b, e: (a.double() - b.double()).abs().max().item() / max(
                e.abs().max().item(), 1e-30)
            errs = [[rel(a, b, e) for a, b, e in zip(x, y, exact)]   # dq, dk, dv
                    for x, y in ((got, want), (got, exact), (want, exact))]
            n, worst = self.seen.get(key, (0, [[0.0] * 3] * 3))
            self.seen[key] = (n + 1, [[max(a, b) for a, b in zip(w, e)]
                                      for w, e in zip(worst, errs)])
            return got

        flash_attention_bwd.launch = held
        return self

    def __exit__(self, *exc):
        from multimodal_context_reasoning_torch.ops.flash import flash_attention_bwd

        del flash_attention_bwd.launch
        return False


class HeldDense:
    """While active, every dense-bias forward launch is held against its
    plain version on the same inputs: per (q shape, k shape, bias shape)
    the launches and the worst |kernel - plain| over max |plain|; with
    ``keep``, the first (q, k, v, bias) of each key."""

    def __init__(self, keep: bool = False):
        self.seen = {}
        self.keep = keep
        self.inputs = {}

    def __enter__(self):
        from multimodal_context_reasoning_torch.ops.fused_attention import (
            fused_attention,
            fused_attention_plain,
        )

        launch = fused_attention.launch

        def held(q, k, v, bias):
            key = (tuple(q.shape), tuple(k.shape), str(q.dtype),
                   None if bias is None else tuple(bias.shape))
            if self.keep and key not in self.inputs:
                self.inputs[key] = tuple(t.detach() for t in (q, k, v, bias))
            got = launch(q, k, v, bias)
            err = errors(got, fused_attention_plain(q, k, v, bias))[1]
            n, worst = self.seen.get(key, (0, 0.0))
            self.seen[key] = (n + 1, max(worst, err))
            return got

        fused_attention.launch = held
        return self

    def __exit__(self, *exc):
        from multimodal_context_reasoning_torch.ops.fused_attention import fused_attention

        del fused_attention.launch
        return False


def held_backward_rows(held) -> dict:
    """``HeldBackward.seen`` by shape: launches, the three error triples
    ([dq, dk, dv], each over its max |exact|) and dq's share of them."""
    return {f"{k[0]} {k[1]} bias {k[2]}": dict(
        launches=n, kernel_vs_plain=w[0], kernel_vs_exact=w[1], plain_vs_exact=w[2],
        dq_share_kernel=w[1][0], dq_share_plain=w[2][0])
        for k, (n, w) in held.seen.items()}


def backward_held_ok(rows) -> bool:
    """The kernel rounds P and dS to bf16 as its plain version (and the
    Pallas kernel) do; where cancellation in dq = dS·K amplifies those
    roundings, the two round differently and both lie far from float64: the
    kernel must lie no further from float64 than its plain version, plus
    the bf16 tolerance."""
    return all(k <= p + BWD_TOL[torch.bfloat16] for h in rows.values()
               for k, p in zip(h["kernel_vs_exact"], h["plain_vs_exact"]))


def rationale_train_phase(rng) -> dict:
    """Phase 18: ``Trainer.fit`` over ``RationaleForTraining`` at full width
    (bf16 encoders computing from fp32 parameters, fp32 GPT-2, encoders
    trainable, dropout 0), RATIONALE_QUESTIONS questions a step, with the
    kernel counts of every step; then one more step with each backward
    launch held against its plain version."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
        ModCRConfig,
        TrainConfig,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.models.rationale import (
        RationaleForTraining,
        RationaleModel,
    )
    from multimodal_context_reasoning_torch.serving.synthetic import hash_tokenizers
    from multimodal_context_reasoning_torch.train.trainer import Trainer

    cfg = ModCRConfig().with_dtype("bfloat16")
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=cfg.global_encoder.img_feature_dim)
    enc = EncoderConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    sched = ChunkAlignConfig()
    gpt = GPT2Config(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    bert, _ = hash_tokenizers(cfg)
    gpt_tok = HashTokenizer(vocab_size=gpt.vocab_size)
    model = RationaleModel(enc, sched, gpt, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 18))
    batches = rationale_batches(rng, RATIONALE_STEPS + 1, RATIONALE_QUESTIONS, cfg, spec, bert,
                                gpt, gpt_tok)
    facade = RationaleForTraining(model)
    tcfg = TrainConfig(per_device_batch_size=RATIONALE_QUESTIONS, max_steps=RATIONALE_STEPS,
                       freeze_encoders=False, learning_rate=1e-4, seed=SEED)
    trainer = Trainer(facade, tcfg, ListLoader(batches[:RATIONALE_STEPS]), device="cuda")
    steps = []
    trainer.train_step = counted(trainer.train_step, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    state = trainer.fit()
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    per_layer = generate_launches_per_forward(enc)   # one per encoder layer
    per_step = {"spec_attention": per_layer, "fused_attention": 0, "flash_bwd": per_layer}
    losses = [float(s["out"]["loss"]) for s in steps]
    check(len(steps) == RATIONALE_STEPS and state.optimizer.count == RATIONALE_STEPS,
          f"18: {len(steps)} steps")
    check(np.isfinite(losses).all(), f"18: non-finite losses {losses}")
    for i, s in enumerate(steps):
        check(s["launches"] == per_step, f"18 step {i}: launches {s['launches']}")
    check(all(p.dtype == torch.float32 for p in model.parameters()), "18: parameters fp32")
    check(sorted(g["scale"] for g in state.optimizer.groups) == [tcfg.seq_enc_lr_scale, 1.0],
          "18: the seq_enc group")
    step_ms = [1e3 * s["seconds"] for s in steps]
    steady = statistics.median(step_ms[1:])

    # one more step, each backward launch against its plain version
    with HeldBackward() as held:
        trainer.train_step(state, trainer.to_device(batches[-1]))
        torch.cuda.synchronize()
    held_rows = held_backward_rows(held)
    held_ok = backward_held_ok(held_rows)
    r = dict(questions_per_step=RATIONALE_QUESTIONS, rows_per_step=4 * RATIONALE_QUESTIONS,
             ms_per_step=step_ms, steady_ms_per_step=steady,
             questions_per_s=RATIONALE_QUESTIONS / steady * 1e3, peak_gib=peak,
             allocated_before_fit_gib=before,
             losses=losses, launches=launches, launches_per_step=steps[0]["launches"],
             backward_held=held_rows)
    print(f"[18 rationale train] bf16 encoders (trainable) + fp32 GPT-2, dropout 0, "
          f"{RATIONALE_QUESTIONS} questions ({4 * RATIONALE_QUESTIONS} rows) a step: losses "
          f"{np.round(losses, 4).tolist()}")
    print(f"[18 rationale train] ms per step {np.round(step_ms, 2).tolist()} -> steady (median "
          f"of steps 2-{RATIONALE_STEPS}) {steady:.2f} ms = {r['questions_per_s']:.2f} "
          f"questions/s ({4 * r['questions_per_s']:.2f} rows/s) | peak {peak:.2f} GiB "
          f"({before:.2f} allocated before fit) | "
          f"launches per step {steps[0]['launches']} (all {RATIONALE_STEPS} equal)")
    print(f"[18 rationale train] one more step, each backward launch against its plain version "
          f"and both against float64 ([dq, dk, dv], each over its max |exact|): "
          f"{r['backward_held']}")
    check(sum(h["launches"] for h in held_rows.values()) == per_layer and held_ok,
          f"18: backward launches against plain and float64 {held_rows}")
    del trainer, state, facade, model, batches
    torch.cuda.empty_cache()
    r["parity"] = rationale_train_parity(rng)
    return r


def rationale_train_parity(rng) -> dict:
    """Phase 18a: two fp32 ``train_step``s of ``RationaleForTraining`` on the
    card (kernels) and on the CPU (plain versions) from one state dict, at a
    small depth (encoders of RATIONALE_PARITY_LAYERS layers, a 2-layer
    GPT-2, full widths), one question: losses and gradient norms within 1e-4
    relative (as phase 9), and every parameter within 2 x steps x lr (two
    Adam steps move an element by at most lr each, in either direction when
    a near-zero gradient's sign differs)."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
        ModCRConfig,
        TrainConfig,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.models.rationale import (
        RationaleForTraining,
        RationaleModel,
    )
    from multimodal_context_reasoning_torch.serving.synthetic import hash_tokenizers
    from multimodal_context_reasoning_torch.train.state import TrainState
    from multimodal_context_reasoning_torch.train.step import train_step

    cfg = ModCRConfig()
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=cfg.global_encoder.img_feature_dim)
    enc = EncoderConfig(num_hidden_layers=RATIONALE_PARITY_LAYERS, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    sched = ChunkAlignConfig(chunk_layers_end=1, full_layers_end=2)
    gpt = GPT2Config(n_layer=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    bert, _ = hash_tokenizers(cfg)
    gpt_tok = HashTokenizer(vocab_size=gpt.vocab_size)
    model = RationaleModel(enc, sched, gpt, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 181))
    cpu_model = copy.deepcopy(model).cpu()
    batch = rationale_batches(rng, 1, 1, cfg, spec, bert, gpt, gpt_tok)[0]
    tcfg = TrainConfig(freeze_encoders=False, learning_rate=1e-4)
    runs, t0 = {}, time.perf_counter()
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        state = TrainState.create(RationaleForTraining(m), tcfg, total_steps=10)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        reset_counts()
        metrics = [train_step(state, tb) for _ in range(2)]
        runs[dev] = dict(loss=[float(x["loss"]) for x in metrics],
                         grad_norm=[float(x["grad_norm"]) for x in metrics],
                         params={k: v.cpu() for k, v in m.state_dict().items()},
                         launches=read_counts())
    seconds = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for key in ("loss", "grad_norm")
              for a, b in zip(runs["cuda"][key], runs["cpu"][key]))
    p_err = max((v - runs["cpu"]["params"][k]).abs().max().item()
                for k, v in runs["cuda"]["params"].items())
    p_tol = 2 * 2 * tcfg.learning_rate
    r = dict(max_rel_diff=rel, max_param_diff=p_err, param_tol=p_tol, seconds=seconds,
             loss={d: runs[d]["loss"] for d in runs}, card_launches=runs["cuda"]["launches"])
    print(f"[18a rationale train parity] fp32, encoders of {RATIONALE_PARITY_LAYERS} layers, "
          f"2-layer GPT-2, full widths, 1 question, 2 steps: cuda loss {runs['cuda']['loss']} "
          f"grad_norm {runs['cuda']['grad_norm']} | cpu loss {runs['cpu']['loss']} grad_norm "
          f"{runs['cpu']['grad_norm']} | max rel diff {rel:.3e} (tol 1e-4) | max |Δ param| "
          f"{p_err:.3e} (tol {p_tol:g}) | card launches {runs['cuda']['launches']} | "
          f"{seconds:.1f} s")
    check(rel <= 1e-4 and p_err <= p_tol, "18a: the card and the CPU disagree")
    check(runs["cuda"]["launches"]["flash_bwd"] == 2 * 2 * RATIONALE_PARITY_LAYERS,
          f"18a launches {runs['cuda']['launches']}")
    del model, cpu_model
    torch.cuda.empty_cache()
    return r


def time_encoder_backward(rng) -> list:
    """Phase 18b: the backward at the rationale family's trainable encoder
    shape, (32, 190, 190, 12, 64) bf16, with each stage's mask as
    the stage-mask op's gradient passes it (``spec_bias``): against its plain version,
    then kernel, plain version and SDPA's backward (the mask as a float
    ``attn_mask``, through autograd) per call and back to back, with the
    bound (inputs read once, dq, dk, dv written once, no dbias plane)."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.spec_attention import spec_bias

    dt, rows = torch.bfloat16, []
    for stage in ("full", "chunk", "cross"):
        rows_ = 4 * RATIONALE_QUESTIONS
        case = attention_case(rng, f"encoder {stage} ({rows_}, 190, 190, 12, 64)", rows_, 140,
                              50, 12, stage)
        q, k, v, *vecs = cuda_args(case, dt)
        bias = spec_bias(*vecs, stage=stage, text_len=case["text_len"], lq=q.shape[1])
        d_out = torch.randn(q.shape, device="cuda", dtype=dt,
                            generator=torch.Generator("cuda").manual_seed(SEED + 4))
        got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True)
        want = flash_attention_bwd_plain(q, k, v, bias, d_out)
        rel = max(errors(g, w)[1] for g, w in zip(got, want))
        err = max(errors(g, w)[0] for g, w in zip(got, want))
        check(rel <= BWD_TOL[dt], f"encoder backward {stage}: rel {rel}")
        del got, want
        mask = bias.to(dt)
        q4, k4, v4 = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out_t = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
        d_out_t = d_out.transpose(1, 2)
        kernel = lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
        library = lambda: torch.autograd.grad(out_t, (q4, k4, v4), d_out_t, retain_graph=True)
        B, L, H, Dh = q.shape
        nbytes = 2 * (7 * B * L * H * Dh) + 4 * bias.numel()
        flops = 10.0 * B * H * L * L * Dh
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
        row = dict(shape=case["name"], bias=list(bias.shape), max_abs_err=err, max_rel_err=rel,
                   ms=median_ms(kernel),
                   plain_ms=median_ms(lambda: flash_attention_bwd_plain(q, k, v, bias, d_out)),
                   library_ms=median_ms(library), b2b_ms=back_to_back_ms(kernel),
                   library_b2b_ms=back_to_back_ms(library),
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rows.append(row)
        print(f"[18b encoder backward] {case['name']:40s} bias {row['bias']}: vs plain "
              f"{err:.2e} ({rel:.1e} rel) | per call: kernel {row['ms']:.4f} | plain "
              f"{row['plain_ms']:.4f} | sdpa {row['library_ms']:.4f} ms; back to back: kernel "
              f"{row['b2b_ms']:.4f} | sdpa {row['library_b2b_ms']:.4f} ms | bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        del q, k, v, q4, k4, v4, out_t
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- the two-stage recipe

def stage1_launches(enc, sched) -> dict:
    """Kernel launches of one stage-1 train step of ``ChunkAlignClassifier``:
    every encoder layer but the ChunkAlign encoder's cross layers (they
    return probabilities for the alignment loss, so they take the plain
    attention) runs the stage-mask forward, and through that op's gradient
    the backward kernel; no layer takes the dense-bias forward.  Full depth:
    12 global + 3 chunk-stage + 6 full-stage = 21.  An evaluation forward
    launches the same stage-mask count and no backward."""
    n = 2 * enc.num_hidden_layers - (enc.num_hidden_layers - sched.full_layers_end)
    return {"spec_attention": n, "fused_attention": 0, "flash_bwd": n}


def stage1_parity(rng) -> dict:
    """Phase 19a: two fp32 ``train_step``s of ``ChunkAlignClassifier`` at
    full width (schedule 3/9, dropout 0, one question) on the card (kernels)
    and on the CPU (plain versions) from one state dict: the binary CE, the
    alignment CE and the gradient norms within 1e-4 relative (as phase 9)."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig, TrainConfig
    from multimodal_context_reasoning_torch.models.chunkalign_cls import ChunkAlignClassifier
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.state import TrainState
    from multimodal_context_reasoning_torch.train.step import train_step

    cfg = ModCRConfig()
    enc = dataclasses.replace(cfg.seq_encoder, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    model = ChunkAlignClassifier(enc, cfg.chunkalign, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(SEED + 19))
    cpu_model = copy.deepcopy(model).cpu()
    batch = {k: v for k, v in synthetic_dataset(rng, 1, cfg, first=190_000).batch([0]).items()
             if not k.startswith("r_")}
    tcfg = TrainConfig(freeze_encoders=False, seq_enc_lr_scale=1.0)
    runs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        state = TrainState.create(m, tcfg, total_steps=10)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        reset_counts()
        t0 = time.perf_counter()
        metrics = [train_step(state, tb) for _ in range(2)]
        runs[dev] = {key: [float(x[key]) for x in metrics]
                     for key in ("loss", "align_loss", "grad_norm")}
        runs[dev]["cls_loss"] = [a - b for a, b in zip(runs[dev]["loss"], runs[dev]["align_loss"])]
        runs[dev].update(seconds=time.perf_counter() - t0, launches=read_counts())
        del state
    keys = ("cls_loss", "align_loss", "grad_norm")
    rel = max(abs(a - b) / max(abs(b), 1e-30) for key in keys
              for a, b in zip(runs["cuda"][key], runs["cpu"][key]))
    print(f"[19a stage-1 parity] full-width fp32 ChunkAlignClassifier, 1 question (4 rows), "
          f"2 steps: " + " | ".join(
              f"{key} cuda {np.round(runs['cuda'][key], 6).tolist()} cpu "
              f"{np.round(runs['cpu'][key], 6).tolist()}" for key in keys)
          + f" | max rel diff {rel:.3e} (tol 1e-4) | card launches {runs['cuda']['launches']} "
          f"| cpu {runs['cpu']['seconds']:.1f} s")
    check(all(np.isfinite(runs["cuda"][k]).all() for k in keys), "19a: non-finite metrics")
    check(min(runs["cuda"]["align_loss"]) > 0, "19a: no alignment loss")
    check(rel <= 1e-4, f"19a: card against CPU rel diff {rel}")
    per_step = stage1_launches(enc, cfg.chunkalign)
    check(runs["cuda"]["launches"] == {k: 2 * v for k, v in per_step.items()},
          f"19a launches {runs['cuda']['launches']}")
    del model, cpu_model
    torch.cuda.empty_cache()
    return dict(max_rel_diff=rel, cuda={k: runs["cuda"][k] for k in keys},
                cpu={k: runs["cpu"][k] for k in keys}, cpu_seconds=runs["cpu"]["seconds"])


class CapturedSpec:
    """While active, keeps the first stage-mask forward launch of each stage
    (its detached inputs); with ``select``, the first launch of each key
    ``select(q, stage)`` gives, None keeping nothing."""

    def __init__(self, select=None):
        self.inputs = {}
        self.select = select or (lambda q, stage: stage)

    def __enter__(self):
        from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

        launch = fused_attention_spec.launch

        def kept(q, k, v, valid, gi, rowfull, *, stage, text_len):
            key = self.select(q, stage)
            if key is not None and key not in self.inputs:
                self.inputs[key] = dict(
                    args=tuple(t.detach() for t in (q, k, v, valid, gi, rowfull)),
                    stage=stage, text_len=text_len)
            return launch(q, k, v, valid, gi, rowfull, stage=stage, text_len=text_len)

        fused_attention_spec.launch = kept
        return self

    def __exit__(self, *exc):
        from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

        del fused_attention_spec.launch
        return False


def held_stage1_pass(model, batch) -> tuple:
    """One more stage-1 forward and backward on a training batch (no
    update), each backward launch held against its plain version and both
    against float64, the first launches kept; the kernel counts are left as
    they were (these launches compare, they are not the path's)."""
    from multimodal_context_reasoning_torch.train.step import model_inputs

    with uncounted(), HeldBackward(keep=True) as held, CapturedSpec() as spec:
        model.train()
        out = model(model_inputs(batch))
        torch.autograd.grad(out.loss, [p for p in model.parameters() if p.requires_grad],
                            allow_unused=True)
        torch.cuda.synchronize()
    return held, spec


def two_stage_phase(rng) -> dict:
    """Phase 19b: ``cli.train_two_stage.main(argv)`` at full width, bf16,
    dropout 0, on PMR rows written from the seed, with every train and eval
    step of both stages counted and timed; after the last stage-1 step one
    held pass (19c's inputs)."""
    from multimodal_context_reasoning_torch.cli import train_two_stage
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.interop.export import chunkalign_cls_keys
    from multimodal_context_reasoning_torch.serving.synthetic import task_rows, write_rows
    from multimodal_context_reasoning_torch.train import trainer as trainer_module

    tmp = tempfile.mkdtemp(prefix="two_stage_")
    cfg = ModCRConfig()
    data = os.path.join(tmp, "pmr.jsonl")
    write_rows(data, task_rows(rng, TWO_STAGE_EXAMPLES, cfg.img_len, first=300_000))
    argv = ["--jsonl", data, "--out", os.path.join(tmp, "out"), "--device", "cuda",
            "--seed", str(SEED), "--stage1_dropout", "0", "--dropout", "0",
            "--stage1_batch", str(TWO_STAGE_QUESTIONS), "--batch", str(TWO_STAGE_QUESTIONS),
            "--stage1_steps", str(STAGE1_STEPS), "--stage2_steps", str(STAGE2_STEPS),
            "--valid_steps", str(TWO_STAGE_VALID)]
    records, peaks, reports, held = [], {}, [], {}
    current = [None]

    def staged(fn, kind):
        def run(*args):
            model = args[0].model if kind == "train" else args[0]
            stage = 1 if type(model).__name__ == "ChunkAlignClassifier" else 2
            if current[0] != stage:
                if current[0] is not None:
                    torch.cuda.synchronize()
                    peaks[current[0]] = torch.cuda.max_memory_allocated() / 2**30
                torch.cuda.reset_peak_memory_stats()
                current[0] = stage
            before = read_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            after = read_counts()
            records.append(dict(kind=kind, stage=stage, out=out, seconds=time.perf_counter() - t0,
                                device_ms=start.elapsed_time(end),
                                launches={k: after[k] - before[k] for k in after}))
            if (kind, stage) == ("train", 1) and sum(
                    r["kind"] == "train" and r["stage"] == 1 for r in records) == STAGE1_STEPS:
                held["held"], held["spec"] = held_stage1_pass(model, args[1])
            return out
        return run

    assemble = train_two_stage.assemble_modcr_params

    def recorded_assemble(*args, **kw):
        reports.append(assemble(*args, **kw))
        return reports[-1]

    saved = (trainer_module.train_step, trainer_module.eval_step)
    trainer_module.train_step = staged(saved[0], "train")
    trainer_module.eval_step = staged(saved[1], "eval")
    train_two_stage.assemble_modcr_params = recorded_assemble
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        curve = train_two_stage.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peaks[current[0]] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        trainer_module.train_step, trainer_module.eval_step = saved
        train_two_stage.assemble_modcr_params = assemble
    npz = os.path.join(tmp, "out", "chunkalign_cls_state_dict.npz")
    with np.load(npz) as z:
        npz_keys = list(z.files)
    shutil.rmtree(tmp)

    cfg2 = train_two_stage.composite_config(train_two_stage.build_arg_parser().parse_args(argv))
    enc = cfg2.seq_encoder
    want = {("train", 1): stage1_launches(enc, cfg2.chunkalign),
            ("eval", 1): {**stage1_launches(enc, cfg2.chunkalign), "flash_bwd": 0},
            ("train", 2): STEP_LAUNCHES,
            ("eval", 2): {"spec_attention": spec_launches_per_eval_forward(cfg2),
                          "fused_attention": (cfg2.roberta.num_hidden_layers
                                              if cfg2.roberta.remat else 0),
                          "flash_bwd": 0}}
    for i, r in enumerate(records):
        check(r["launches"] == want[(r["kind"], r["stage"])],
              f"19b record {i} ({r['kind']}, stage {r['stage']}): launches {r['launches']}, "
              f"want {want[(r['kind'], r['stage'])]}")
    steps = {st: [r for r in records if r["kind"] == "train" and r["stage"] == st]
             for st in (1, 2)}
    losses = {st: [float(r["out"]["loss"]) for r in steps[st]] for st in (1, 2)}
    check(len(steps[1]) == STAGE1_STEPS and len(steps[2]) == STAGE2_STEPS,
          f"19b: {len(steps[1])} / {len(steps[2])} train steps")
    check(all(np.isfinite(v).all() for v in losses.values()), f"19b: losses {losses}")
    check(npz_keys == chunkalign_cls_keys(enc), "19b: the export's keys")
    report = reports[0]
    n_tower = sum(k.startswith(("global_enc.", "seq_enc.")) for k in npz_keys)
    check(len(reports) == 1 and not report.unconsumed and not report.skipped
          and len(report.consumed) == n_tower, f"19b: graft {report.summary()}")
    check(set(curve) == {"task", "data", "n_train", "n_val", "batch", "stage1_batch", "lr1",
                         "lr2", "align_weight", "seed", "tiny", "stage1", "stage2"}
          and set(curve["stage1"]) == {"steps", "baseline_acc", "best_acc", "final_acc",
                                       "wall_seconds", "history"}
          and set(curve["stage2"]) == {"steps", "post_surgery_acc", "best_acc", "final_acc",
                                       "wall_seconds", "history"}
          and len(curve["stage1"]["history"]) == STAGE1_STEPS // TWO_STAGE_VALID
          and len(curve["stage2"]["history"]) == 1 + STAGE2_STEPS // TWO_STAGE_VALID,
          f"19b: curve {json.dumps(curve)[:400]}")
    check(all(launches[k] > 0 for k in KERNELS), f"19b launches {launches}")
    stage_launches = {st: {k: sum(r["launches"][k] for r in records if r["stage"] == st)
                           for k in KERNELS} for st in (1, 2)}
    check({k: stage_launches[1][k] + stage_launches[2][k] for k in KERNELS} == launches,
          f"19b: launches outside the steps {launches}")
    device_ms = {st: [r["device_ms"] for r in steps[st]] for st in (1, 2)}
    steady = {st: statistics.median(device_ms[st][1:]) for st in (1, 2)}
    r = dict(stage1_questions_per_step=TWO_STAGE_QUESTIONS, stage1_rows=4 * TWO_STAGE_QUESTIONS,
             stage1_ms_per_step=device_ms[1], stage2_ms_per_step=device_ms[2],
             stage1_steady_ms=steady[1], stage2_steady_ms=steady[2],
             stage1_questions_per_s=TWO_STAGE_QUESTIONS / steady[1] * 1e3,
             peak_gib={f"stage{k}": v for k, v in peaks.items()}, wall_seconds=wall,
             losses=losses, launches=launches, stage1_launches=stage_launches[1],
             stage1_launches_per_step=want[("train", 1)],
             stage1_launches_per_eval=want[("eval", 1)],
             stage2_launches_per_eval=want[("eval", 2)],
             stage2_launches=stage_launches[2], graft=report.summary(),
             post_surgery_acc=curve["stage2"]["post_surgery_acc"],
             stage1_best_acc=curve["stage1"]["best_acc"],
             stage2_best_acc=curve["stage2"]["best_acc"],
             stage1_wall_seconds=curve["stage1"]["wall_seconds"],
             stage2_wall_seconds=curve["stage2"]["wall_seconds"])
    print(f"[19b two-stage] full-width bf16, dropout 0, {TWO_STAGE_QUESTIONS} questions "
          f"({4 * TWO_STAGE_QUESTIONS} rows) a step: stage-1 losses "
          f"{np.round(losses[1], 4).tolist()} | stage-2 losses {np.round(losses[2], 4).tolist()}")
    print(f"[19b two-stage] device ms per step: stage 1 {np.round(device_ms[1], 2).tolist()} -> "
          f"median of steps 2-{STAGE1_STEPS} {steady[1]:.2f} ms = "
          f"{r['stage1_questions_per_s']:.2f} questions/s | stage 2 "
          f"{np.round(device_ms[2], 2).tolist()} -> {steady[2]:.2f} ms | peak "
          f"{r['peak_gib']} GiB | main() wall {wall:.2f} s (stage 1 fit "
          f"{r['stage1_wall_seconds']} s, stage 2 fit {r['stage2_wall_seconds']} s)")
    print(f"[19b two-stage] launches per step: stage 1 {steps[1][0]['launches']}, stage 2 "
          f"{steps[2][0]['launches']}; per eval forward {want[('eval', 1)]} / "
          f"{want[('eval', 2)]} (all equal) | stage 1 {stage_launches[1]}, stage 2 "
          f"{stage_launches[2]} | export {len(npz_keys)} keys | graft {report.summary()} | "
          f"accuracy: stage-1 best {r['stage1_best_acc']:.4f}, post-surgery "
          f"{r['post_surgery_acc']:.4f}, stage-2 best {r['stage2_best_acc']:.4f}")
    r["held"] = held
    return r


def time_stage1_kernels(held, spec, per_step: int) -> dict:
    """Phase 19c: the held pass's backward launches against their plain
    version and float64 (dq's distance from float64 as a share of max |dq|,
    kernel and plain), then the stage-mask forward and the backward at the
    stage-1 shape on the kept full-stage and chunk-stage inputs: kernel,
    plain version and SDPA per call and back to back, and the bound."""
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )

    dt = torch.bfloat16
    held_rows = held_backward_rows(held)
    print(f"[19c stage-1 backward] one more stage-1 step, each backward launch against its plain "
          f"version and both against float64 ([dq, dk, dv], each over its max |exact|): "
          f"{held_rows}")
    check(backward_held_ok(held_rows),
          f"19c: backward launches against plain and float64 {held_rows}")
    fwd_rows, bwd_rows = [], []
    for stage in ("full", "chunk"):
        kept = spec.inputs[stage]
        q, k, v, valid, gi, rowfull = kept["args"]
        check(q.dtype == dt, f"19c: {stage} forward in {q.dtype}")
        kw = dict(stage=stage, text_len=kept["text_len"])
        case = dict(q=q, k=k, stage=stage, text_len=kept["text_len"])
        name = f"stage-1 encoder {stage} {tuple(q.shape[:2]) + (k.shape[1],) + tuple(q.shape[2:])}"
        kernel = lambda: fused_attention_spec(q, k, v, valid, gi, rowfull, **kw)
        plain = lambda: spec_attention_plain(q, k, v, valid, gi, rowfull, **kw)
        sdpa = sdpa_call(q, k, v, valid, gi, rowfull, case)
        err = errors(kernel(), plain())[0]
        check(err <= TOL[dt], f"19c {stage} forward: {err}")
        b_ms, b_by = bound(case, dt)
        row = dict(shape=name, kind="forward", max_abs_err=err, ms=median_ms(kernel),
                   plain_ms=median_ms(plain), library_ms=median_ms(sdpa),
                   b2b_ms=back_to_back_ms(kernel), library_b2b_ms=back_to_back_ms(sdpa),
                   bound_ms=b_ms, bound_by=b_by)
        fwd_rows.append(row)
        print(f"[19c stage-1 forward] {name:44s} vs plain {err:.2e} | per call: kernel "
              f"{row['ms']:.4f} | plain {row['plain_ms']:.4f} | sdpa {row['library_ms']:.4f} ms; "
              f"back to back: kernel {row['b2b_ms']:.4f} | sdpa {row['library_b2b_ms']:.4f} ms "
              f"| bound {b_ms:.4f} ms ({b_by})")

        key = next(key for key in held.inputs if key[2] is not None
                   and (key[2][2] == 1) == (stage == "full"))
        bwd_rows.append(time_backward("19c stage-1 backward",
                                      name.replace("encoder", "encoder backward"),
                                      held.inputs[key],
                                      held_rows[f"{key[0]} {key[1]} bias {key[2]}"]))
    check(sum(h["launches"] for h in held_rows.values()) == per_step,
          f"19c: held launches {held_rows}")
    torch.cuda.empty_cache()
    return dict(forward=fwd_rows, backward=bwd_rows, held=held_rows)


def time_backward(tag: str, name: str, inputs, share: dict) -> dict:
    """The backward kernel on kept (q, k, v, bias, dO) of one held pass:
    against its plain version, with ``share`` (its ``held_backward_rows``
    row) beside it; kernel, plain version and SDPA's backward per call and
    back to back, and the bound."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    q, k, v, bias, d_out = inputs
    dt = q.dtype
    got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    err = max(errors(g, w)[0] for g, w in zip(got[:3], want[:3]))   # dq, dk, dv
    del got, want
    q4, k4, v4 = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out_t = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias.to(dt))
    d_out_t = d_out.transpose(1, 2)
    kernel = lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    library = lambda: torch.autograd.grad(out_t, (q4, k4, v4), d_out_t, retain_graph=True)
    B, L, H, Dh = q.shape
    nbytes = 2 * (7 * B * L * H * Dh) + 4 * bias.numel()
    flops = 10.0 * B * H * L * L * Dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    row = dict(shape=name, bias=list(bias.shape), kind="backward", max_abs_err=err,
               ms=median_ms(kernel),
               plain_ms=median_ms(lambda: flash_attention_bwd_plain(q, k, v, bias, d_out)),
               library_ms=median_ms(library), b2b_ms=back_to_back_ms(kernel),
               library_b2b_ms=back_to_back_ms(library), bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               launches_per_step=share["launches"], dq_share_kernel=share["dq_share_kernel"],
               dq_share_plain=share["dq_share_plain"])
    print(f"[{tag}] {name:44s} bias {row['bias']}: vs plain {err:.2e} | dq "
          f"from float64 over max |dq|: kernel {row['dq_share_kernel']:.4f}, plain "
          f"{row['dq_share_plain']:.4f} | per call: kernel {row['ms']:.4f} | plain "
          f"{row['plain_ms']:.4f} | sdpa {row['library_ms']:.4f} ms; back to back: kernel "
          f"{row['b2b_ms']:.4f} | sdpa {row['library_b2b_ms']:.4f} ms | bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def time_dense_forward(tag: str, name: str, inputs, held: tuple) -> dict:
    """The dense-bias forward on kept (q, k, v, bias) of one held pass:
    against its plain version, with ``held`` (its launches and worst error
    over max |plain| in that pass) beside it; kernel, plain version and SDPA
    per call and back to back, and the bound."""
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )

    q, k, v, bias = inputs
    dt = q.dtype
    mask = bias.to(dt)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: fused_attention(q, k, v, bias)
    plain = lambda: fused_attention_plain(q, k, v, bias)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    err, rel = errors(kernel(), plain())
    check(rel <= TOL[dt], f"{tag} {name}: {rel} of max |plain|")
    b_ms, b_by = train_bound(dict(q=q, k=k), dt, "forward")
    row = dict(shape=name, bias=list(bias.shape), kind="forward", max_abs_err=err,
               max_rel_err=rel, launches_per_step=held[0], held_max_rel_err=held[1],
               ms=median_ms(kernel), plain_ms=median_ms(plain), library_ms=median_ms(library),
               b2b_ms=back_to_back_ms(kernel), library_b2b_ms=back_to_back_ms(library),
               bound_ms=b_ms, bound_by=b_by)
    print(f"[{tag}] {name:44s} bias {row['bias']}: vs plain {err:.2e} ({rel:.2e} of max "
          f"|plain|; {held[0]} launches of the held step, worst {held[1]:.2e}) | per call: "
          f"kernel {row['ms']:.4f} | plain {row['plain_ms']:.4f} | sdpa "
          f"{row['library_ms']:.4f} ms; back to back: kernel {row['b2b_ms']:.4f} | sdpa "
          f"{row['library_b2b_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
    return row


# ---------------------------------------------------------------- ensembles and CLIP

def ensemble_launches_per_forward(cfg, text_view: str) -> int:
    """Stage-mask launches of one deterministic ``DualEnsembleModel``
    forward: the global encoder once (no vision pass), the ChunkAlign
    encoder without its cross-stage layers (they return the alignment
    probabilities), and RoBERTa's layers in the "full" stage with no prefix
    unless ``remat`` or ``scan_layers`` gives them the dense bias; the
    GPT-2 view's attention is plain.  Full width: 12 + 9 + 24 = 45, or 21."""
    cross = cfg.seq_encoder.num_hidden_layers - cfg.chunkalign.full_layers_end
    rob = 0 if text_view == "gpt2" or cfg.roberta.remat or cfg.roberta.scan_layers \
        else cfg.roberta.num_hidden_layers
    return cfg.global_encoder.num_hidden_layers + cfg.seq_encoder.num_hidden_layers - cross + rob


def gpt2_view_config():
    """The GPT-2 view's default tower (GPT-2 small at the encoders' width, no
    cross-attention) with its dropouts at 0, as the encoders'."""
    from multimodal_context_reasoning_torch.core.config import GPT2Config

    return GPT2Config(n_embd=768, add_cross_attention=False, resid_pdrop=0.0,
                      embd_pdrop=0.0, attn_pdrop=0.0)


def gpt2_byte_bpe():
    """A GPT-2 byte-level BPE tokenizer (``data/subword.py``) over the
    synthetic words: the 256 byte symbols, one merge chain per word with its
    leading space, ``<|endoftext|>`` as bos, eos and pad (GPT-2's one
    special), the 45 ``<|det#|>`` tokens after it; every id below GPT-2's
    50,257."""
    from multimodal_context_reasoning_torch.data.subword import ByteBPETokenizer, bytes_to_unicode
    from multimodal_context_reasoning_torch.serving.synthetic import OBJECTS, WORDS

    be = bytes_to_unicode()
    vocab = {be[b]: b for b in range(256)}
    merges = []
    for word in sorted(set(WORDS) | set(OBJECTS) | {"and", "."}):
        sym = [be[b] for b in (" " + word).encode()]
        while len(sym) > 1:
            if (sym[0], sym[1]) not in merges:
                merges.append((sym[0], sym[1]))
                vocab[sym[0] + sym[1]] = len(vocab)
            sym = [sym[0] + sym[1]] + sym[2:]
    vocab["<|endoftext|>"] = len(vocab)
    eot = "<|endoftext|>"
    return ByteBPETokenizer(vocab, merges, unk_token=eot, cls_token=eot, sep_token=eot,
                            pad_token=eot)


def ensemble_batches(rng, cfg, questions: int, first: int) -> dict:
    """One batch of ``questions`` questions for each text view, from the
    seed: the RoBERTa view's through ``PMRDataset`` (the hash tokenizers),
    the GPT-2 view's through ``VCRDataset(lm_style="gpt")`` with the GPT-2
    byte-BPE tokenizer; numpy arrays."""
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.vcr import VCRDataset
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_dataset,
        synthetic_examples,
    )

    rob = synthetic_dataset(rng, questions, cfg, first=first).batch(list(range(questions)))
    feats, examples = synthetic_examples(rng, questions, cfg, first=first + questions)
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     num_labels=cfg.num_labels, img_feature_dim=cfg.global_encoder.img_feature_dim)
    gpt_ds = VCRDataset(examples, feats, hash_tokenizers(cfg)[0], gpt2_byte_bpe(), spec=spec,
                        max_chunks=cfg.max_chunks, lm_style="gpt")
    return {"roberta": rob, "gpt2": gpt_ds.batch(list(range(questions)))}


def to_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def group_grad_norms(model, loss) -> dict:
    """The gradient norm of each top-level parameter group, summed in
    float64 on the CPU (a CPU fp32 norm of 10M elements drifts by ~4e-4)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    sums = {}
    for (name, _), g in zip(named, grads):
        if g is not None:
            group = name.split(".")[0]
            sums[group] = sums.get(group, 0.0) + float((g.detach().cpu().double() ** 2).sum())
    return {k: v ** 0.5 for k, v in sums.items()}


def rel(a, b) -> float:
    """max |a - b| over max |b| (scalars: |a - b| / |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def ensemble_parity(rng) -> dict:
    """Phase 20a: full-width fp32 ``DualEnsembleModel`` (dropout 0, one
    question) on the card (kernels) and on the CPU (plain versions) from one
    state dict: the RoBERTa view's logits, loss, alignment loss and every
    parameter group's gradient norm, the GPT-2 view's forward
    (``gpt_pool="last_real"``); then the CLIP ViT-B/16 towers in fp32 on 2
    seeded images and 8 id rows; all within 1e-4 relative."""
    from multimodal_context_reasoning_torch.core.config import CLIPConfig, pmr_training_config
    from multimodal_context_reasoning_torch.models.clip import CLIP
    from multimodal_context_reasoning_torch.models.ensemble import DualEnsembleModel

    cfg = pmr_training_config(dtype="float32", remat=False)
    batches = ensemble_batches(rng, cfg, 1, first=400_000)
    out = {}
    for view, pool, kw in (("roberta", "first", dict(fusion="concat", loss="ce+hinge")),
                           ("gpt2", "last_real", dict(fusion="concat", loss="ce"))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
        kw.update(text_view=view, gpt_pool=pool, gpt2_config=gpt2_view_config())
        model = DualEnsembleModel(cfg, device="cuda", generator=gen, **kw).train()
        cpu_model = DualEnsembleModel(cfg, device="cpu", **kw).train()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        runs = {}
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            reset_counts()
            t0 = time.perf_counter()
            res, align = m(to_device(batches[view], dev))
            r = dict(logits=res.logits.detach().cpu().numpy(), loss=res.loss.item(),
                     align_loss=align.item())
            if view == "roberta":
                r["grad_norms"] = group_grad_norms(m, res.loss + align)
            if dev == "cuda":
                torch.cuda.synchronize()
            r.update(seconds=time.perf_counter() - t0, launches=read_counts())
            runs[dev] = r
        c, g = runs["cpu"], runs["cuda"]
        diffs = {k: rel(g[k], c[k]) for k in ("logits", "loss", "align_loss")}
        if view == "roberta":
            diffs.update({f"grad {k}": rel(g["grad_norms"][k], v)
                          for k, v in c["grad_norms"].items()})
            check(set(g["grad_norms"]) == {"global_enc", "seq_enc", "fusion", "roberta",
                                           "ensemble"}, f"groups {g['grad_norms']}")
        worst = max(diffs.values())
        n_fwd = ensemble_launches_per_forward(cfg, view)
        want = {"spec_attention": n_fwd, "fused_attention": 0,
                "flash_bwd": n_fwd if view == "roberta" else 0}
        print(f"[20a parity] full-width fp32 DualEnsembleModel({view}, {kw['fusion']}, "
              f"{kw['loss']}, pool {pool}), dropout 0, 1 question: cuda logits "
              f"{np.round(g['logits'], 5).tolist()} loss {g['loss']:.6f} align "
              f"{g['align_loss']:.6f} | max rel diff {worst:.3e} (tol 1e-4) {diffs} | card "
              f"launches {g['launches']} | cpu {c['seconds']:.1f} s")
        check(np.isfinite(g["logits"]).all() and np.isfinite([g["loss"], g["align_loss"]]).all(),
              f"20a {view}: non-finite")
        check(worst <= 1e-4, f"20a {view}: rel diff {diffs}")
        check(g["launches"] == want, f"20a {view}: launches {g['launches']}, want {want}")
        out[view] = dict(max_rel_diff=worst, diffs=diffs, launches=g["launches"],
                         cpu_seconds=c["seconds"])
        del model, cpu_model
        torch.cuda.empty_cache()

    ccfg = CLIPConfig()
    clip = CLIP(ccfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    cpu_clip = CLIP(ccfg, device="cpu")
    cpu_clip.load_state_dict({k: v.cpu() for k, v in clip.state_dict().items()})
    px, ids = clip_inputs(rng, 2, 8)
    diffs = {}
    with torch.inference_mode():
        for name, x in (("image", px), ("text", ids)):
            enc = "encode_image" if name == "image" else "encode_text"
            got = getattr(clip, enc)(torch.from_numpy(x).cuda()).cpu()
            want = getattr(cpu_clip, enc)(torch.from_numpy(x))
            check(torch.isfinite(got).all().item(), f"20a CLIP {name}: non-finite")
            diffs[name] = rel(got.numpy(), want.numpy())
    print(f"[20a parity] CLIP ViT-B/16 fp32, 2 images and 8 id rows: max rel diff card vs cpu "
          f"{diffs} (tol 1e-4)")
    check(max(diffs.values()) <= 1e-4, f"20a CLIP: {diffs}")
    out["clip"] = diffs
    return out


def clip_inputs(rng, n_images: int, n_rows: int, cfg=None):
    """Seeded normalized pixels [n, S, S, 3] and id rows [n_rows, T]: SOT,
    random ids, EOT (the largest id) at a random length, zeros after."""
    from multimodal_context_reasoning_torch.core.config import CLIPConfig

    cfg = cfg or CLIPConfig()
    px = rng.standard_normal((n_images, cfg.image_size, cfg.image_size, 3), dtype=np.float32)
    ids = np.zeros((n_rows, cfg.context_length), np.int64)
    for r, n in enumerate(rng.integers(4, cfg.context_length + 1, n_rows)):
        ids[r, 0] = cfg.vocab_size - 2
        ids[r, 1:n - 1] = rng.integers(1, cfg.vocab_size - 2, n - 2)
        ids[r, n - 1] = cfg.vocab_size - 1
    return px, ids


def ensemble_path(rng, serving_ms: float) -> dict:
    """Phase 20b, the slice's main path: full-width bf16 ``DualEnsembleModel``
    (dropout 0) evaluation forwards of ``ENSEMBLE_QUESTIONS`` questions for
    ``fusion`` concat and add with the RoBERTa view and one with the GPT-2
    view, each launching exactly ``ensemble_launches_per_forward``
    stage-mask kernels; then one forward and backward of the RoBERTa view
    under ``pmr_training_config()`` (RoBERTa remat "full", encoders frozen):
    exactly 21 stage-mask, 48 dense-forward and 24 backward launches, and
    one more held against the plain versions (not counted).  The counts are
    set to 0 before the path and read after it.  ms per forward
    (CUDA events, median of 10 after 3 warm-up calls), examples/s, the
    device time of one profiled forward and peak memory, beside
    ``ModCRModel``'s serving forward on the same batch and phase 6's
    ``ModCRScorer`` (``serving_ms``, per micro-batch).  The
    first RoBERTa stage-mask launch's inputs and the held step's are kept
    for 20e and the ensemble head's inputs for 20c."""
    from multimodal_context_reasoning_torch.core.config import pmr_training_config
    from multimodal_context_reasoning_torch.models.ensemble import DualEnsembleModel
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel

    cfg = pmr_training_config(remat=False)        # bf16, dropout 0
    Q = ENSEMBLE_QUESTIONS
    batches = {k: to_device(v, "cuda")
               for k, v in ensemble_batches(rng, cfg, Q, first=410_000).items()}
    out, kept, heads = {}, None, {}
    torch.cuda.synchronize()
    reset_counts()
    for name, view, fusion in (("roberta-concat", "roberta", "concat"),
                               ("roberta-add", "roberta", "add"),
                               ("gpt2-last_real", "gpt2", "concat")):
        model = DualEnsembleModel(cfg, fusion=fusion, loss="ce", text_view=view,
                                  gpt_pool="last_real", gpt2_config=gpt2_view_config(),
                                  device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
        model.eval()
        batch = batches[view]
        def keep_views(module, args, result, name=name):
            heads.setdefault(name, {k: v.detach() for k, v in args[0].items()})

        hook = model.ensemble.register_forward_hook(keep_views)
        n_fwd = ensemble_launches_per_forward(cfg, view)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        with torch.inference_mode():
            if kept is None:
                with CapturedSpec(select=lambda q, stage: "roberta"
                                  if q.shape[1:3] == (cfg.roberta_len, 16) else None) as spec:
                    res, align = model(batch)
                kept = spec.inputs["roberta"]
            else:
                res, align = model(batch)
            torch.cuda.synchronize()
            after = read_counts()
            hook.remove()
            launches = {k: after[k] - before[k] for k in after}
            logits = res.logits.float().cpu().numpy()
            check(logits.shape == (Q, cfg.num_labels) and np.isfinite(logits).all()
                  and np.isfinite(float(align)), f"20b {name}: logits {logits.shape}")
            check(launches == {"spec_attention": n_fwd, "fused_attention": 0, "flash_bwd": 0},
                  f"20b {name}: launches {launches}, want {n_fwd} stage-mask")
            ms = median_ms(lambda: model(batch), reps=10)
            device_ms, n_kernels = device_profile(lambda: model(batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[name] = dict(launches_per_forward=launches, ms=ms, examples_per_s=Q / ms * 1e3,
                         device_ms=device_ms, device_kernels=n_kernels, peak_gib=peak,
                         logits=logits.tolist())
        print(f"[20b ensembles] bf16 {name}, {Q} questions ({4 * Q} rows): launches per "
              f"forward {launches} (want {n_fwd} stage-mask) | {ms:.2f} ms per forward = "
              f"{Q / ms * 1e3:.2f} examples/s; device kernels {device_ms:.2f} ms over "
              f"{n_kernels} launches (torch.profiler) | peak {peak:.2f} GiB | logits[0] "
              f"{np.round(logits[0], 4).tolist()}")
        del model
        torch.cuda.empty_cache()

    # the gradient phase: RoBERTa under remat "full", the encoders frozen
    tcfg = pmr_training_config()
    model = DualEnsembleModel(tcfg, fusion="concat", loss="ce+hinge", device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(SEED)).train()
    for p in (*model.global_enc.parameters(), *model.seq_enc.parameters()):
        p.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    batch = batches["roberta"]
    step_ms, step_launches = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        before = read_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res, align = model(batch)
        grads = torch.autograd.grad(res.loss + align, params)
        end.record()
        end.synchronize()
        after = read_counts()
        step_ms.append(start.elapsed_time(end))
        step_launches.append({k: after[k] - before[k] for k in after})
        check(all(torch.isfinite(g).all().item() for g in grads) and np.isfinite(res.loss.item()),
              "20b gradient phase: non-finite")
        del grads
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"spec_attention": 21, "fused_attention": 48, "flash_bwd": 24}
    for got in step_launches:
        check(got == want, f"20b gradient phase launches {got}, want {want}")
    launches = read_counts()
    out["train"] = dict(launches_per_step=step_launches[0], ms=step_ms,
                        steady_ms=statistics.median(step_ms[1:]), peak_gib=peak,
                        trainable_params=sum(p.numel() for p in params))
    print(f"[20b ensembles] bf16 RoBERTa view under pmr_training_config (remat full, encoders "
          f"frozen, {out['train']['trainable_params'] / 1e6:.1f}M trainable), one forward and "
          f"backward of {Q} questions: launches {step_launches[0]} (all 3 equal) | ms "
          f"{np.round(step_ms, 2).tolist()} | peak {peak:.2f} GiB")
    print(f"[20b ensembles] launches over the path: {launches}")
    check(all(launches[k] > 0 for k in KERNELS), f"20b path launches {launches}")

    # one more step, each dense-forward and backward launch held against its
    # plain version (these launches compare, they are not the path's)
    with uncounted(), HeldDense(keep=True) as dense, HeldBackward(keep=True) as held:
        res, align = model(batch)
        torch.autograd.grad(res.loss + align, params)
        torch.cuda.synchronize()
    dense_rows = {f"{k[0]} k {k[1]} {k[2]} bias {k[3]}": dict(launches=n, max_rel_err=w)
                  for k, (n, w) in dense.seen.items()}
    bwd_rows = held_backward_rows(held)
    out["train"]["held"] = dict(dense_forward=dense_rows, backward=bwd_rows)
    print(f"[20b ensembles] one more step, each dense-forward launch against its plain version "
          f"(over max |plain|, tol {TOL[torch.bfloat16]}): {dense_rows}")
    print(f"[20b ensembles] and each backward launch against its plain version and both against "
          f"float64 ([dq, dk, dv], each over its max |exact|): {bwd_rows}")
    check(sum(h["launches"] for h in dense_rows.values()) == want["fused_attention"]
          and all(h["max_rel_err"] <= TOL[torch.bfloat16] for h in dense_rows.values()),
          f"20b: dense-forward launches against plain {dense_rows}")
    check(sum(h["launches"] for h in bwd_rows.values()) == want["flash_bwd"]
          and backward_held_ok(bwd_rows),
          f"20b: backward launches against plain and float64 {bwd_rows}")
    kept = dict(spec=kept, dense=dense, held=held, backward_rows=bwd_rows)
    del model, params
    torch.cuda.empty_cache()

    # beside it, ModCR's serving forward on the same batch (not counted)
    modcr = ModCRModel(dataclasses.replace(cfg, compute_alignment=False), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
    with torch.inference_mode():
        modcr_ms = median_ms(lambda: modcr(batches["roberta"]), reps=10)
        modcr_device_ms, modcr_kernels = device_profile(lambda: modcr(batches["roberta"]))
    out.update(modcr_forward_ms=modcr_ms, modcr_device_ms=modcr_device_ms)
    print(f"[20b ensembles] beside: ModCRModel bf16 forward (alignment off, 60 stage-mask "
          f"launches) on the same {Q} questions {modcr_ms:.2f} ms = {Q / modcr_ms * 1e3:.2f} "
          f"examples/s; device kernels {modcr_device_ms:.2f} ms over {modcr_kernels} launches; "
          f"phase 6's ModCRScorer at micro-batch {Q}: {serving_ms:.2f} ms per micro-batch "
          f"(bf16 weights, host featurize included)")
    del modcr
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out, kept, heads


def clip_path(rng, heads) -> dict:
    """Phase 20c: the ViT-B/16 towers at full width in bf16 and fp32 on
    seeded normalized pixels [32, 224, 224, 3] and id rows [128, 77]
    (ms per call, CUDA events, median of 10 after 3; images/s); then
    ``ClipEndToEnd`` with both variants on 8 images and their 32 candidate
    rows, and ``ClipGatedEnsemble`` and ``ClipSimilarityFusion`` over 20b's
    CALeC and RoBERTa vectors with tied scores: finite, and the gate equal
    to a numpy twin."""
    from multimodal_context_reasoning_torch.core.config import CLIPConfig
    from multimodal_context_reasoning_torch.models.clip import CLIP
    from multimodal_context_reasoning_torch.models.clip_ensemble import (
        ClipEndToEnd,
        ClipGatedEnsemble,
        ClipSimilarityFusion,
        clip_similarity,
        clip_top2_gate,
    )

    out = {}
    ccfg = CLIPConfig()
    clip = CLIP(ccfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    sd = clip.state_dict()
    px, ids = clip_inputs(rng, CLIP_IMAGES, 4 * CLIP_IMAGES)
    px_d, ids_d = torch.from_numpy(px).cuda(), torch.from_numpy(ids).cuda()
    embs = {}
    torch.cuda.reset_peak_memory_stats()
    for dtype in ("bfloat16", "float32"):
        model = CLIP(dataclasses.replace(ccfg, dtype=dtype), device="cuda").eval()
        model.load_state_dict(sd)
        with torch.inference_mode():
            for tower, enc, x in (("image", model.encode_image, px_d),
                                  ("text", model.encode_text, ids_d)):
                e = enc(x)
                check(torch.isfinite(e).all().item() and e.shape == (x.shape[0], 512),
                      f"20c {dtype} {tower}: {tuple(e.shape)}")
                embs[dtype, tower] = e.float()
                ms = median_ms(lambda: enc(x), reps=10)
                out[f"{tower}_{dtype}_ms"] = ms
                rate = x.shape[0] / ms * 1e3
                print(f"[20c clip] ViT-B/16 {tower} tower {dtype}, {x.shape[0]} "
                      f"{'images' if tower == 'image' else 'id rows'} {tuple(x.shape)}: "
                      f"{ms:.2f} ms per call = {rate:.1f} "
                      f"{'images' if tower == 'image' else 'rows'}/s")
        del model
    peak = torch.cuda.max_memory_allocated() / 2**30
    bf_err = {t: rel(embs["bfloat16", t].cpu().numpy(), embs["float32", t].cpu().numpy())
              for t in ("image", "text")}
    out.update(peak_gib=peak, bf16_vs_fp32=bf_err)
    print(f"[20c clip] peak {peak:.2f} GiB | bf16 against fp32 embeddings, max |diff| over max "
          f"|fp32|: {bf_err} (not a check)")

    Q = ENSEMBLE_QUESTIONS
    logits = {}
    for variant in ("fusion", "product"):
        m = ClipEndToEnd(ccfg, variant=variant, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
        m.clip.load_state_dict(sd)
        label = torch.zeros(Q, 4, device="cuda")
        label[:, 0] = 1.0
        with torch.inference_mode():
            r = m(px_d[:Q], ids_d[:4 * Q], label)
        check(r.logits.shape == (Q, 4) and torch.isfinite(r.logits).all().item()
              and torch.isfinite(r.loss).item(), f"20c ClipEndToEnd {variant}")
        logits[variant] = r.logits.cpu().numpy()
        del m
    img = embs["float32", "image"][:Q]
    txt = embs["float32", "text"][:4 * Q].view(Q, 4, -1).clone()
    txt[0, 2] = txt[0, 1]            # tied candidates: 1 and 2 of question 0,
    txt[1, :] = txt[1, 0]            # all four of question 1
    sim = clip_similarity(img, txt)
    sim[0, 2] = sim[0, 1]            # the same ties, exact in the scores
    sim[1, :] = sim[1, 0]
    gate = clip_top2_gate(sim).cpu().numpy()
    s = sim.cpu().numpy()
    twin = np.ones_like(s)           # lax.top_k: of tied scores the lower index first
    for q in range(Q):
        top2 = np.argsort(-s[q], kind="stable")[:2]
        twin[q, top2] = s[q, top2].mean()
    gate_err = float(np.abs(gate - twin).max())
    calec, rob = (heads["roberta-concat"][k].clone() for k in ("calec", "roberta"))
    label = torch.zeros(Q, 4, device="cuda")
    label[:, 0] = 1.0
    with torch.no_grad():
        head = ClipGatedEnsemble(feature_dim=calec.shape[1] + rob.shape[1]).cuda()
        g = head(calec, rob, img, txt, label.view(-1))
        f = ClipSimilarityFusion()(torch.from_numpy(logits["fusion"]).cuda(), img, txt, label)
    check(gate_err <= 1e-6 and (gate[1, :2] == s[1, 0]).all() and (gate[1, 2:] == 1).all(),
          f"20c gate vs numpy twin {gate_err}, {gate[:2]}")
    check(torch.isfinite(g.logits).all().item() and torch.isfinite(g.loss).item()
          and torch.isfinite(f.logits).all().item(), "20c CLIP-gated heads: non-finite")
    out.update(end_to_end_logits={k: v.tolist() for k, v in logits.items()},
               gate_max_abs_diff_vs_numpy=gate_err)
    print(f"[20c clip] ClipEndToEnd on {Q} images and {4 * Q} candidate rows: fusion logits[0] "
          f"{np.round(logits['fusion'][0], 4).tolist()}, product logits[0] "
          f"{np.round(logits['product'][0], 4).tolist()} | ClipGatedEnsemble over 20b's CALeC "
          f"{tuple(calec.shape)} and RoBERTa {tuple(rob.shape)} vectors: loss "
          f"{float(g.loss):.4f}; gate with ties against its numpy twin max |diff| "
          f"{gate_err:.1e}, question 1 (four tied) {np.round(gate[1], 4).tolist()}")
    del clip
    torch.cuda.empty_cache()
    return out


def clip_command(rng) -> dict:
    """Phase 20d: ``cli.precompute_clip.main(argv)`` at full width on the
    card: a random ViT-B/16 checkpoint in OpenAI's layout (``torch.save`` of
    the port's state dict), a merges file from ``build_test_merges`` (the
    vocabulary cut to it through ``--config_overrides``, the only cut from
    ViT-B/16), 32 examples over 16 seeded PNG images; both packs read back
    and held against direct tower calls (1e-4 of max |direct|, fp32).  A
    side whose host package (PIL for images, ``regex`` for text) is absent
    does not run, and a line says so."""
    import importlib.util

    from multimodal_context_reasoning_torch.cli import precompute_clip
    from multimodal_context_reasoning_torch.core.config import CLIPConfig
    from multimodal_context_reasoning_torch.data.clip_preprocess import preprocess_image
    from multimodal_context_reasoning_torch.data.clip_tokenizer import build_test_merges
    from multimodal_context_reasoning_torch.data.feature_store import FeatureStore
    from multimodal_context_reasoning_torch.models.clip import CLIP
    from multimodal_context_reasoning_torch.serving.synthetic import OBJECTS, WORDS

    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "regex")}
    sides = [s for s, m in (("image", "PIL"), ("text", "regex")) if have[m]]
    for side, mod in (("image", "PIL"), ("text", "regex")):
        if not have[mod]:
            print(f"[20d command] {mod} is absent on this machine: the {side} side of "
                  f"precompute_clip did not run")
    check(bool(sides), "20d: neither PIL nor regex: the command cannot run")
    tmp = tempfile.mkdtemp(prefix="clip_cmd_")
    merges = build_test_merges((list(WORDS) + list(OBJECTS)) * 3, max_merges=4096)
    full = CLIPConfig()
    cfg = dataclasses.replace(full, vocab_size=512 + len(merges) + 2)
    print(f"[20d command] the one cut from ViT-B/16: vocab_size {full.vocab_size} -> "
          f"{cfg.vocab_size} (a merges table of {len(merges)} from build_test_merges)")
    model = CLIP(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    ckpt = os.path.join(tmp, "ViT-B-16.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    bpe = os.path.join(tmp, "merges.txt")
    with open(bpe, "w") as fh:
        fh.write("#version: test\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    rows = []
    if "image" in sides:
        from PIL import Image

        for i in range(CLIP_CMD_IMAGES):
            h, w = (int(x) for x in rng.integers(200, 480, 2))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(tmp, f"img_{i}.png"))
    for i in range(CLIP_CMD_EXAMPLES):
        objects = [str(o) for o in rng.choice(OBJECTS, 3)]
        choice = lambda: [str(w) for w in rng.choice(WORDS, int(rng.integers(3, 9)))] + [[0, 2]]
        rows.append({"img_id": f"img-{i % CLIP_CMD_IMAGES}",
                     "img_fn": f"img_{i % CLIP_CMD_IMAGES}.png", "total_id": f"ex-{i}",
                     "objects": objects, "answer_choices": [choice() for _ in range(4)]})
    jsonl = os.path.join(tmp, "examples.jsonl")
    with open(jsonl, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in rows)
    packs = {s: os.path.join(tmp, f"clip_{s}.mcrpack") for s in sides}
    argv = ["--checkpoint", ckpt, "--examples_jsonl", jsonl, "--device", "cuda",
            "--config_overrides", json.dumps({"vocab_size": cfg.vocab_size})]
    if "image" in sides:
        argv += ["--images_root", tmp, "--out_image_pack", packs["image"]]
    if "text" in sides:
        argv += ["--bpe_vocab", bpe, "--out_text_pack", packs["text"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    precompute_clip.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model.eval()
    errs = {}
    with torch.inference_mode():
        if "image" in sides:
            store = FeatureStore(packs["image"])
            keys = sorted(store.keys())
            check(keys == sorted({r["img_id"] for r in rows}), f"20d image keys {keys[:3]}")
            px = np.stack([preprocess_image(os.path.join(tmp, f"img_{k.split('-')[1]}.png"),
                                            cfg.image_size) for k in keys])
            direct = model.encode_image(torch.from_numpy(px).cuda()).float().cpu().numpy()
            got = np.concatenate([store[k].features for k in keys])
            errs["image"] = rel(got, direct)
            store.close()
        if "text" in sides:
            from multimodal_context_reasoning_torch.data.clip_tokenizer import ClipTokenizer

            store = FeatureStore(packs["text"])
            keys = [r["total_id"] for r in rows]
            check(sorted(store.keys()) == sorted(keys), "20d text keys")
            tok = ClipTokenizer(bpe)
            texts = [precompute_clip.render_plain(c, r["objects"]) for r in rows
                     for c in r["answer_choices"]]
            ids = tok.tokenize(texts, cfg.context_length, truncate=True).astype(np.int64)
            direct = model.encode_text(torch.from_numpy(ids).cuda()).float().cpu().numpy()
            got = np.concatenate([store[k].features for k in keys])
            check(all(store[k].features.shape == (4, 512) for k in keys), "20d text blocks")
            errs["text"] = rel(got, direct)
            store.close()
    shutil.rmtree(tmp)
    print(f"[20d command] precompute_clip.main at full width (fp32, --batch 32) on "
          f"{CLIP_CMD_EXAMPLES} examples over {CLIP_CMD_IMAGES} images: sides {sides}, wall "
          f"{wall:.2f} s | packs against direct tower calls, max |diff| over max |direct|: "
          f"{errs} (tol 1e-4)")
    check(all(e <= 1e-4 for e in errs.values()), f"20d packs {errs}")
    del model
    torch.cuda.empty_cache()
    return dict(sides=sides, wall_s=wall, max_rel_diff=errs, vocab_size=cfg.vocab_size,
                absent=[m for m, h in have.items() if not h])


def roberta_no_prefix_kernels(kept) -> dict:
    """Phase 20e: the three kernels at RoBERTa's no-prefix shape (32, 128,
    128, 16, 64), bf16, each on a RoBERTa layer's real inputs from 20b: the
    stage-mask forward's from an evaluation forward (against its plain
    version, 2e-2 abs), the dense-bias forward's and the backward's from the
    held gradient step (2e-2 of max |plain|; the backward beside its
    float64 error); each kernel, its plain version and SDPA per call and
    back to back, and the bound."""
    with uncounted():
        spec = roberta_no_prefix_spec(kept["spec"])
        (dkey, dense_in), = kept["dense"].inputs.items()
        (bkey, bwd_in), = kept["held"].inputs.items()
        B, L, H, Dh = dense_in[0].shape
        shape = f"({B}, {L}, {dense_in[1].shape[1]}, {H}, {Dh})"
        dense = time_dense_forward("20e kernel", f"roberta no prefix {shape}", dense_in,
                                   kept["dense"].seen[dkey])
        bwd = time_backward("20e kernel", f"roberta backward no prefix {shape}", bwd_in,
                            kept["backward_rows"][f"{bkey[0]} {bkey[1]} bias {bkey[2]}"])
    return dict(spec=spec, dense=[dense], backward=[bwd])


def roberta_no_prefix_spec(kept) -> list:
    """Phase 20e's stage-mask forward: against its plain version (2e-2
    abs), then kernel, plain version and SDPA per call and back to back,
    and the bound."""
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )

    dt = torch.bfloat16
    # copies outside inference mode (the 20b forward ran under it)
    q, k, v, valid, gi, rowfull = (t.clone() for t in kept["args"])
    kw = dict(stage=kept["stage"], text_len=kept["text_len"])
    check(q.dtype == dt and kept["stage"] == "full" and q.shape[1] == k.shape[1],
          f"20e: kept {q.dtype} {kept['stage']} {tuple(q.shape)} {tuple(k.shape)}")
    case = dict(q=q, k=k, stage=kept["stage"], text_len=kept["text_len"])
    name = f"roberta no prefix {tuple(q.shape[:2]) + (k.shape[1],) + tuple(q.shape[2:])}"
    kernel = lambda: fused_attention_spec(q, k, v, valid, gi, rowfull, **kw)
    plain = lambda: spec_attention_plain(q, k, v, valid, gi, rowfull, **kw)
    sdpa = sdpa_call(q, k, v, valid, gi, rowfull, case)
    err = errors(kernel(), plain())[0]
    check(err <= TOL[dt], f"20e forward: {err}")
    b_ms, b_by = bound(case, dt)
    row = dict(shape=name, max_abs_err=err, ms=median_ms(kernel), plain_ms=median_ms(plain),
               library_ms=median_ms(sdpa), b2b_ms=back_to_back_ms(kernel),
               plain_b2b_ms=back_to_back_ms(plain), library_b2b_ms=back_to_back_ms(sdpa),
               bound_ms=b_ms, bound_by=b_by)
    print(f"[20e kernel] {name:40s} vs plain {err:.2e} (tol 2e-2) | per call: kernel "
          f"{row['ms']:.4f} | plain {row['plain_ms']:.4f} | sdpa {row['library_ms']:.4f} ms; "
          f"back to back: kernel {row['b2b_ms']:.4f} | plain {row['plain_b2b_ms']:.4f} | sdpa "
          f"{row['library_b2b_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
    return [row]


# ---------------------------------------------------------------- ops, AOT, table, profiler

def host_us_per_call(fn, n: int = 1000, window: int = 100) -> tuple:
    """(host µs per call, device µs per call) of ``n`` calls with no
    synchronisation inside the loop, and the host µs per call of the same
    calls in windows of ``window`` (synchronised between windows, outside
    the timed part): a window never fills the launch queue, so it times the
    host alone, while the ``n``-call loop blocks on a full queue wherever
    the device takes longer than the host."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    windows = []
    for _ in range(n // window):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(window):
            fn()
        windows.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return (1e6 * host / n, 1e3 * start.elapsed_time(end) / n,
            1e6 * statistics.median(windows) / window)


def probe_custom_op():
    """A ``torch.library.custom_op`` twin of the stage-mask op over the same
    launcher, in a namespace of its own: the host cost of that route, beside
    the ``Library`` one the port registers (never on a path of the port)."""
    from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

    @torch.library.custom_op("modcr_probe::spec_attention", mutates_args=())
    def probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
              gi: torch.Tensor, rowfull: torch.Tensor, stage: str,
              text_len: int) -> torch.Tensor:
        return fused_attention_spec.launch(q, k, v, valid, gi, rowfull, stage=stage,
                                           text_len=text_len)

    return probe


def ops_phase(rng) -> dict:
    """Phase 21a: each op bit-equal to its direct launcher at the phase-3
    micro-batch-8 shapes and the phase-7 training shapes in bf16 (and the
    stage-mask op's gradients to the direct backward launch on the stage
    bias); ``torch.library.opcheck`` on CUDA at a small shape, fp32 and
    bf16; host µs per call, direct launcher against the op (and against a
    ``custom_op`` twin) at the micro-batch-8 shapes, 1,000 calls each."""
    from multimodal_context_reasoning_torch.ops.flash import FLASH_BWD, flash_attention_bwd
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        DENSE_ATTENTION,
        fused_attention,
    )
    from multimodal_context_reasoning_torch.ops.masks import padding_bias
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        SPEC_ATTENTION,
        fused_attention_spec,
        spec_bias,
    )

    out = dict(bit_equal={}, opcheck={}, host=[])
    probe = probe_custom_op()
    with uncounted():
        for case, n_fwd in shapes(rng, 8):
            args = cuda_args(case, torch.bfloat16)
            kw = dict(stage=case["stage"], text_len=case["text_len"])
            same = torch.equal(fused_attention_spec(*args, **kw),
                               fused_attention_spec.launch(*args, **kw))
            out["bit_equal"][f"spec {case['name']}"] = same
            check(same, f"21a: the stage-mask op differs from its launcher at {case['name']}")
            direct = lambda: fused_attention_spec.launch(*args, **kw)
            op = lambda: fused_attention_spec(*args, **kw)
            custom = lambda: probe(*args, case["stage"], case["text_len"])
            row = dict(shape=case["name"], launches_per_forward=n_fwd)
            for name, fn in (("direct", direct), ("op", op), ("custom_op", custom),
                             ("op", op), ("direct", direct)):
                h, d, w = host_us_per_call(fn)
                row.setdefault(f"{name}_host_us_1000", []).append(h)
                row.setdefault(f"{name}_device_us", []).append(d)
                row.setdefault(f"{name}_host_us", []).append(w)
            out["host"].append(row)
            r2 = lambda xs: [round(x, 2) for x in xs]
            print(f"[21a ops] {case['name']:33s} host µs per call (windows of 100, in turns): "
                  f"direct {r2(row['direct_host_us'])} | op {r2(row['op_host_us'])} | "
                  f"custom_op {r2(row['custom_op_host_us'])}; 1000 calls in one loop: host "
                  f"direct {r2(row['direct_host_us_1000'])} op {r2(row['op_host_us_1000'])}, "
                  f"device direct {r2(row['direct_device_us'])} op {r2(row['op_device_us'])}")
            del args
        # the training shapes: the dense forward and the backward (with the
        # dbias plane), row bias at RoBERTa's, the chunk plane at 190 keys
        case = dense_case(rng, **TRAIN_SHAPE)
        q, k, v, d_out = (case[n].to("cuda", torch.bfloat16) for n in ("q", "k", "v", "d_out"))
        chunk = attention_case(rng, "chunk L=190", 32, 140, 50, 12, "chunk")
        cq, ck, cv, *cvec = cuda_args(chunk, torch.bfloat16)
        cbias = spec_bias(*cvec, stage="chunk", text_len=chunk["text_len"], lq=cq.shape[1])
        c_dout = torch.randn(cq.shape, device="cuda", dtype=torch.bfloat16,
                             generator=torch.Generator("cuda").manual_seed(SEED + 21))
        for name, (a, b, c, bias, g) in (
                ("(128, 128, 138, 16, 64) row bias", (q, k, v, padding_bias(
                    case["valid"].cuda()), d_out)),
                ("(32, 190, 190, 12, 64) chunk plane", (cq, ck, cv, cbias, c_dout))):
            same = torch.equal(fused_attention(a, b, c, bias), fused_attention.launch(a, b, c, bias))
            got = flash_attention_bwd(a, b, c, bias, g, want_dbias=False)
            want = flash_attention_bwd.launch(a, b, c, bias, g, want_dbias=False)
            same_bwd = all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
            out["bit_equal"][f"dense {name}"] = same
            out["bit_equal"][f"backward {name}"] = same_bwd
            check(same and same_bwd, f"21a: dense {same} / backward {same_bwd} op differs "
                                     f"from its launcher at {name}")
            # with the dbias plane: its head sum is taken with atomics, so
            # two launches of the kernel itself may differ in its last bits
            got = flash_attention_bwd(a, b, c, bias, g, want_dbias=True)
            want = flash_attention_bwd.launch(a, b, c, bias, g, want_dbias=True)
            again = flash_attention_bwd.launch(a, b, c, bias, g, want_dbias=True)
            same_grads = all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
            _, rel = errors(got[3], want[3])
            out["bit_equal"][f"backward with dbias {name}"] = dict(
                dq_dk_dv=same_grads, dbias=torch.equal(got[3], want[3]),
                dbias_two_launches=torch.equal(want[3], again[3]), dbias_rel=rel)
            check(same_grads and rel <= BWD_TOL[torch.bfloat16],
                  f"21a: backward with dbias at {name}: dq/dk/dv equal {same_grads}, dbias "
                  f"{rel} of max |dbias| from the launcher's")
        # host µs per call of the two training kernels at a small batch of
        # RoBERTa's shape (4 rows), where the device takes less than the host
        sq, sk, sv, sd = (t[:4] for t in (q, k, v, d_out))
        sb = padding_bias(case["valid"][:4].cuda())
        for name, direct, op in (
                ("fused_attention", lambda: fused_attention.launch(sq, sk, sv, sb),
                 lambda: fused_attention(sq, sk, sv, sb)),
                ("flash_bwd", lambda: flash_attention_bwd.launch(sq, sk, sv, sb, sd,
                                                                 want_dbias=False),
                 lambda: flash_attention_bwd(sq, sk, sv, sb, sd, want_dbias=False))):
            row = dict(kernel=name, shape="(4, 128, 138, 16, 64)")
            for turn, fn in (("direct", direct), ("op", op), ("op", op), ("direct", direct)):
                h, d, w = host_us_per_call(fn)
                row.setdefault(f"{turn}_host_us_1000", []).append(h)
                row.setdefault(f"{turn}_device_us", []).append(d)
                row.setdefault(f"{turn}_host_us", []).append(w)
            out[f"{name}_host"] = row
            print(f"[21a ops] {name} (4, 128, 138, 16, 64) host µs per call: direct "
                  f"{row['direct_host_us']} | op {row['op_host_us']} | device µs direct "
                  f"{row['direct_device_us']} op {row['op_device_us']}")
        # the stage-mask op's gradient: the backward launch on the stage bias
        leaves = [t.detach().clone().requires_grad_() for t in (cq, ck, cv)]
        fused_attention_spec(*leaves, *cvec, stage="chunk",
                             text_len=chunk["text_len"]).backward(c_dout)
        want = flash_attention_bwd.launch(cq, ck, cv, cbias, c_dout, want_dbias=False)
        same = all(torch.equal(x.grad, y) for x, y in zip(leaves, want[:3]))
        out["bit_equal"]["spec gradient (32, 190, 190, 12, 64) chunk"] = same
        check(same, "21a: the stage-mask op's gradients differ from the direct backward")
        del leaves, want, got, again
        # opcheck on the card at a small shape, fp32 (FP32 pipes) and bf16
        small = attention_case(rng, "small", 2, 12, 12, 2, "chunk")
        for dtype in (torch.float32, torch.bfloat16):
            sq, sk, sv, *svec = cuda_args(small, dtype)
            sbias = spec_bias(*svec, stage="chunk", text_len=small["text_len"], lq=sq.shape[1])
            s_dout = torch.randn(sq.shape, device="cuda", dtype=dtype,
                                 generator=torch.Generator("cuda").manual_seed(SEED))
            for name, op, args in (
                    ("spec_attention", SPEC_ATTENTION,
                     (sq.requires_grad_(), sk, sv, *svec, "chunk", small["text_len"])),
                    ("dense_attention", DENSE_ATTENTION, (sq, sk, sv, sbias)),
                    ("flash_bwd", FLASH_BWD, (sq.detach(), sk, sv, sbias, s_dout, True))):
                res = torch.library.opcheck(op, args)
                ok = all(v == "SUCCESS" for v in res.values())
                out["opcheck"][f"{name} {str(dtype)[6:]}"] = ok
                check(ok, f"21a: opcheck {name} {dtype}: {res}")
    print(f"[21a ops] bit-equal to the direct launchers: {out['bit_equal']}")
    print(f"[21a ops] opcheck on the card (2, 24, 24, 2, 64): {out['opcheck']}")
    med = lambda key: statistics.median(x for r in out["host"] for x in r[key])
    out["op_host_us"] = dict(direct=med("direct_host_us"), op=med("op_host_us"),
                             custom_op=med("custom_op_host_us"))
    print(f"[21a ops] host µs per call, median over the 5 shapes and both turns: "
          f"{out['op_host_us']}")
    return out


def batch_nbytes(batch) -> int:
    """Bytes a batch copies from the host: its numpy arrays (a device
    table's tensors are already on the card)."""
    return sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray))


def device_table_phase(rng) -> dict:
    """Phase 21b: the full-width bf16 scorer (alignment off, 60 stage-mask
    launches a forward) with the device table against the host path on one
    set of weights, logits bit-equal, collate + copy ms and bytes per
    micro-batch of 8; then one training forward and backward at phase 10's
    geometry on one model, host, table, host: the loss bit-equal, the
    gradients within phase 7's fp32 backward bound (1e-4 of max |g|) of
    host mode's, beside host mode against its own second run (the backward
    is not bit-reproducible on the card), 36 / 48 / 24 launches in table
    mode, bytes per step."""
    from multimodal_context_reasoning_torch.core.config import (
        ModCRConfig,
        pmr_training_config,
    )
    from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer, build_host_batch
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_dataset,
        synthetic_requests,
    )
    from multimodal_context_reasoning_torch.train.step import model_inputs

    out = {}
    cfg = dataclasses.replace(ModCRConfig(), compute_alignment=False).with_dtype("bfloat16")
    sd = ModCRModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(
        SEED + 21)).state_dict()
    feats, reqs = synthetic_requests(rng, 8 * 5, cfg, first=210_000)
    scorers = {mode: ModCRScorer(cfg, sd, *hash_tokenizers(cfg), feats, micro_batch=8,
                                 device="cuda", use_device_table=(mode == "table"))
               for mode in ("host", "table")}
    del sd
    rows, copy_ms, nbytes = {}, {}, {}
    for mode, sc in scorers.items():
        sc.score(reqs[:8])                     # warm
        reset_counts()
        rows[mode] = sc.score(reqs[8:])
        torch.cuda.synchronize()
        launches = read_counts()
        check(launches["spec_attention"] == LAUNCHES_PER_FORWARD * 4,
              f"21b {mode}: {launches} over 4 forwards")
        featd = [sc.featurize(ex) for ex in reqs[8:16]]
        nbytes[mode] = batch_nbytes(build_host_batch(featd, sc._ds.spec, cfg.num_labels,
                                                     table_mode=mode == "table"))
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.device_batch(featd)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        copy_ms[mode] = statistics.median(times)
        out[f"{mode}_launches"] = launches
    same = all(a["logits"] == b["logits"] for a, b in zip(rows["host"], rows["table"]))
    err = max(np.abs(np.subtract(a["logits"], b["logits"])).max()
              for a, b in zip(rows["host"], rows["table"]))
    table_bytes = scorers["table"].table.nbytes
    out["scorer"] = dict(logits_bit_equal=same, max_abs_diff=float(err),
                         collate_copy_ms=copy_ms, bytes_per_micro_batch=nbytes,
                         table_bytes=table_bytes, table_images=len(scorers["table"].table.row))
    print(f"[21b table] full-width bf16 scorer, micro-batch 8, 4 forwards each: logits "
          f"bit-equal host/table {same} (max |diff| {err:.3e}) | launches table mode "
          f"{out['table_launches']} | collate + copy per micro-batch {copy_ms} ms | bytes "
          f"copied per micro-batch {nbytes} | table {table_bytes} B once "
          f"({out['scorer']['table_images']} images)")
    check(same, f"21b: table-mode logits differ from host mode by {err}")
    del scorers
    torch.cuda.empty_cache()

    # one training step's forward and backward at phase 10's geometry, each
    # mode on one model, host mode twice: its own spread is the yardstick
    tcfg = pmr_training_config()
    ds = synthetic_dataset(rng, TRAIN_EXAMPLES, tcfg, first=220_000)
    host_batch = ds.batch(np.arange(TRAIN_EXAMPLES))
    table = DeviceFeatureTable.for_config(ds.image_features, tcfg, device="cuda")
    ds.use_device_table(table)
    table_batch = ds.batch(np.arange(TRAIN_EXAMPLES))
    model = ModCRModel(tcfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(
        SEED + 22)).train()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    step = {}
    for run, (mode, batch) in enumerate((("host", host_batch), ("table", table_batch),
                                         ("host", host_batch))):
        dev = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v).cuda()
               for k, v in batch.items()}
        reset_counts()
        loss = model(model_inputs(dev)).loss
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        torch.cuda.synchronize()
        step[f"{mode}{run}"] = dict(loss=loss.item(), launches=read_counts(),
                                    bytes=batch_nbytes(batch),
                                    grads=[None if g is None else g.float() for g in grads])
        del dev, loss, grads

    def grad_gap(a, b):
        """Worst |Δ| of any gradient over its max |g|, whether all are
        equal, and the parameters whose gradients differ."""
        pairs = [(n, x, y) for (n, _), x, y in zip(named, step[a]["grads"], step[b]["grads"])
                 if x is not None]
        differ = [n for n, x, y in pairs if not torch.equal(x, y)]
        return (max(((x - y).abs().max() / x.abs().max().clamp_min(1e-30)).item()
                    for _, x, y in pairs), not differ, differ)
    table_gap, table_equal, table_differ = grad_gap("host0", "table1")
    host_gap, host_equal, host_differ = grad_gap("host0", "host2")
    check(step["table1"]["launches"] == STEP_LAUNCHES,
          f"21b: table-mode step launches {step['table1']['launches']}")
    out["train_step"] = dict(
        loss={k: r["loss"] for k, r in step.items()},
        launches=step["table1"]["launches"],
        bytes={"host": step["host0"]["bytes"], "table": step["table1"]["bytes"]},
        grads_bit_equal_table=table_equal, grads_bit_equal_host_twice=host_equal,
        grads_differ_table=table_differ, grads_differ_host_twice=host_differ,
        grad_rel_gap_table=table_gap, grad_rel_gap_host_twice=host_gap,
        table_bytes=table.nbytes)
    same_loss = step["host0"]["loss"] == step["table1"]["loss"] == step["host2"]["loss"]
    print(f"[21b table] one training forward and backward, {TRAIN_EXAMPLES} examples: loss "
          f"host {step['host0']['loss']} table {step['table1']['loss']} host again "
          f"{step['host2']['loss']} | gradients table vs host bit-equal {table_equal} (worst "
          f"{table_gap:.3e} of max |g|; differing {table_differ}), host vs host bit-equal "
          f"{host_equal} ({host_gap:.3e}; differing {host_differ}) | "
          f"launches table mode {step['table1']['launches']} | bytes copied per step host "
          f"{step['host0']['bytes']} table {step['table1']['bytes']}")
    # the backward's atomics make host mode differ from itself in the last
    # bits; the table's gradients are held to phase 7's fp32 backward bound
    check(same_loss and table_gap <= BWD_TOL[torch.float32],
          f"21b: table mode's step differs from host mode's (loss equal {same_loss}, "
          f"gradients {table_gap} of max |g|, host against itself {host_gap})")
    out["launches"] = step["table1"]["launches"]
    del model, step, table, named
    torch.cuda.empty_cache()
    return out


def run_command(tmp: str, name: str, argv: list, timeout: float = 600) -> tuple:
    """A ``cli.serve`` run to its end (the save flags exit after the export):
    (wall seconds, its log)."""
    log_path = os.path.join(tmp, f"{name}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(
            [sys.executable, "-m", "multimodal_context_reasoning_torch.cli.serve",
             "--compute_dtype", "bfloat16", *argv], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, timeout=timeout)
    text = open(log_path).read()
    check(proc.returncode == 0, f"{name} exited {proc.returncode}: {text[-2000:]}")
    return time.perf_counter() - t0, text


def exported_seconds(log: str) -> float:
    m = re.search(r"\(export ([0-9.]+) s\)", log)
    check(m is not None, f"no export time in {log[-500:]}")
    return float(m.group(1))


def aot_scorer_phase(rng, live_startup_s: float) -> dict:
    """Phase 21c: ``serve --save_artifact`` then ``serve --artifact`` as
    processes at full width, bf16, micro-batch 8 (the serve command's
    seed-0 weights, alignment on), the artifact command under phase 14's
    clients with replies held against the live scorer; the artifact loaded
    in-process scores bit-equal to the live scorer with the counts set to 0
    before and read after (57 launches a forward); ms per micro-batch of
    both, standup seconds against the live command's (phase 14)."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.aot import PROGRAM_FILE, AOTScorer
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = ModCRConfig().with_dtype("bfloat16")
    sizes = rng.integers(SERVE_EXAMPLES[0], SERVE_EXAMPLES[1] + 1,
                         (SERVE_CLIENTS, SERVE_REQUESTS))
    feats, examples = synthetic_requests(rng, int(sizes.sum()) + SERVE_CLIENTS, cfg,
                                         first=230_000)
    warm_plan = [[{"examples": [as_json(ex)]}] for ex in examples[:SERVE_CLIENTS]]
    it = iter(examples[SERVE_CLIENTS:])
    plan = [[{"examples": [as_json(next(it)) for _ in range(n)]} for n in row] for row in sizes]
    measured = examples[SERVE_CLIENTS:]
    tmp = tempfile.mkdtemp(prefix="modcr_aot_")
    art = os.path.join(tmp, "scorer")
    out = {}
    try:
        pack = os.path.join(tmp, "feats.mcrpack")
        write_pack({k: v.features for k, v in feats.items()}, pack)
        save_s, log = run_command(tmp, "save", ["--img_feat_file", pack, "--micro_batch",
                                                str(SERVE_MICRO_BATCH), "--save_artifact", art])
        out.update(save_command_s=save_s, export_s=exported_seconds(log),
                   program_bytes=os.path.getsize(os.path.join(art, PROGRAM_FILE)),
                   params_bytes=os.path.getsize(os.path.join(art, "params.pt")))
        proc, port, log_path, startup = start_serve_command(tmp, pack, "--artifact", art)
        try:
            http_load(port, warm_plan)
            replies, wall = http_load(port, plan)
            stats = http(port, "/stats")[1]
        finally:
            exited = stop_serve_command(proc)
        check(exited, "the serve --artifact command did not exit on SIGTERM")
        started = [ln for ln in open(log_path).read().splitlines() if "serving AOT" in ln]

        model = ModCRModel(cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
        live = ModCRScorer(cfg, model, *hash_tokenizers(cfg), feats,
                           micro_batch=SERVE_MICRO_BATCH, device="cuda")
        live.warm_up()
        t0 = time.perf_counter()
        loaded = AOTScorer(art, *hash_tokenizers(cfg), feats)
        load_s = time.perf_counter() - t0
        timed = {}
        for name, sc in (("live", live), ("aot", loaded), ("aot", loaded), ("live", live)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = sc.score(measured)
            torch.cuda.synchronize()
            timed.setdefault(name, []).append(dict(
                rows=res, seconds=time.perf_counter() - t0, launches=read_counts()))
        direct = {r["example_id"]: np.asarray(r["logits"]) for r in timed["live"][0]["rows"]}
        forwards = -(-len(measured) // SERVE_MICRO_BATCH)
        per_forward = spec_launches_per_eval_forward(cfg)
        same = all(a == b for r in timed["aot"] for a, b in zip(r["rows"],
                                                                   timed["live"][0]["rows"]))
        check(same, "21c: the loaded artifact's scores differ from the live scorer's")
        check(all(r["launches"]["spec_attention"] == per_forward * forwards
                  for r in timed["aot"]), f"21c: AOT launches {timed['aot'][0]['launches']}")
        http_r = load_summary(replies, wall, direct, "serve --artifact command")
        exact = sum(np.array_equal(np.asarray(r["logits"]), direct[r["example_id"]])
                    for row in replies for _, o, _ in row for r in o["results"])
        ms = {k: [1e3 * r["seconds"] / forwards for r in v] for k, v in timed.items()}
        out.update(startup_s=startup, live_startup_s=live_startup_s, load_in_process_s=load_s,
                   http=http_r, http_exactly_equal=int(exact),
                   forwards=stats["routes"]["score"]["device_dispatches"],
                   ms_per_micro_batch=ms, launches_per_forward=per_forward,
                   launches=timed["aot"][0]["launches"], bit_equal_in_process=same)
        print(f"[21c aot scorer] save command {save_s:.2f} s beside 21d's export (export "
              f"{out['export_s']:.2f} s), "
              f"program {out['program_bytes']} B, params {out['params_bytes']} B | "
              f"{started} after {startup:.2f} s to /healthz (live command, phase 14: "
              f"{live_startup_s:.2f} s) | in-process load {load_s:.2f} s")
        print(f"[21c aot scorer] the artifact command under {SERVE_CLIENTS} clients: "
              f"{http_r['examples_per_s']:.2f} ex/s, p50 {http_r['p50_ms']:.2f} ms, p99 "
              f"{http_r['p99_ms']:.2f} ms | max |http - live| {http_r['max_abs_diff']:.3e} "
              f"(tol {http_r['tol']:.3e}), {exact}/{http_r['examples']} replies bit-equal")
        print(f"[21c aot scorer] in-process, {len(measured)} examples in {forwards} "
              f"micro-batches of 8, in turns: ms per micro-batch {ms} | bit-equal {same} | "
              f"launches {out['launches']} = {per_forward} x {forwards}")
        del loaded, live, model
    finally:
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    return out


def start_generator_export(rng) -> dict:
    """Phase 21d, first half: the questions, their feature pack, and ``serve
    --generate --save_gen_artifact`` started as a process (phase 16's
    geometry: bf16 encoders, fp32 GPT-2, 4 questions a forward, 32 greedy
    steps, the command's seed-0 weights).  It exports while phases 21b and
    21c run; :func:`aot_generator_phase` waits for it."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_requests

    cfg = ModCRConfig().with_dtype("bfloat16")
    sizes = rng.integers(GEN_QUESTIONS[0], GEN_QUESTIONS[1] + 1, (GEN_CLIENTS, GEN_REQUESTS))
    feats, qs = synthetic_requests(rng, int(sizes.sum()) + GEN_CLIENTS, cfg, first=240_000)
    tmp = tempfile.mkdtemp(prefix="modcr_aot_gen_")
    pack = os.path.join(tmp, "feats.mcrpack")
    write_pack({k: v.features for k, v in feats.items()}, pack)
    flags = ["--micro_batch", str(SERVE_MICRO_BATCH), "--gen_micro_batch",
             str(GEN_MICRO_BATCH), "--max_rationale_len", str(GEN_MAX_LEN)]
    art = os.path.join(tmp, "generator")
    log_path = os.path.join(tmp, "save_gen.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_context_reasoning_torch.cli.serve",
             "--compute_dtype", "bfloat16", "--img_feat_file", pack, *flags, "--generate",
             "--save_gen_artifact", art], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return dict(cfg=cfg, sizes=sizes, feats=feats, qs=qs, tmp=tmp, pack=pack, flags=flags,
                art=art, log_path=log_path, proc=proc, t0=time.perf_counter())


def aot_generator_phase(started: dict) -> dict:
    """Phase 21d: wait for the ``--save_gen_artifact`` process; start
    ``serve --gen_artifact`` as a process and, beside its standup, load the
    artifact in-process; the command's /generate replies held against live
    generation under phase 16's clients; then in turns live and loaded
    generation of the same questions: tokens equal, 24 launches per classify
    forward with the counts set to 0 before and read after, ms per
    micro-batch; export seconds and program bytes."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel
    from multimodal_context_reasoning_torch.serving.aot import GEN_PROGRAM_FILE, AOTGenerator
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
    from multimodal_context_reasoning_torch.serving.synthetic import hash_tokenizers

    cfg, feats, qs, tmp, art = (started[k] for k in ("cfg", "feats", "qs", "tmp", "art"))
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=cfg.global_encoder.img_feature_dim)
    enc, sched, gpt = EncoderConfig(dtype="bfloat16"), ChunkAlignConfig(), GPT2Config()
    bert, _ = hash_tokenizers(cfg)
    gpt_tok = HashTokenizer(vocab_size=gpt.vocab_size)
    warm_plan = [[{"examples": [as_json(q)]}] for q in qs[:GEN_CLIENTS]]
    it = iter(qs[GEN_CLIENTS:])
    plan = [[{"examples": [as_json(next(it)) for _ in range(n)]} for n in row]
            for row in started["sizes"]]
    measured = qs[GEN_CLIENTS:]
    out = {}
    try:
        try:
            code = started["proc"].wait(timeout=600)
        except subprocess.TimeoutExpired:
            started["proc"].kill()
            raise
        log = open(started["log_path"]).read()
        check(code == 0, f"the --save_gen_artifact command exited {code}: {log[-2000:]}")
        out.update(save_command_s=time.perf_counter() - started["t0"],
                   export_s=exported_seconds(log),
                   program_bytes=os.path.getsize(os.path.join(art, GEN_PROGRAM_FILE)),
                   params_bytes=os.path.getsize(os.path.join(art, "params.pt")))
        proc, port, log_path = start_serve_command_nowait(tmp, started["pack"],
                                                          *started["flags"], "--gen_artifact",
                                                          art)
        try:
            t0 = time.perf_counter()
            loaded = AOTGenerator(art, bert, gpt_tok, feats)
            load_s = time.perf_counter() - t0
            startup = wait_healthz(proc, port, log_path, started_at=t0)
            http_load(port, warm_plan, "/generate")
            replies, wall = http_load(port, plan, "/generate")
        finally:
            exited = stop_serve_command(proc)
        check(exited, "the serve --gen_artifact command did not exit on SIGTERM")
        model = RationaleModel(enc, sched, gpt, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(0))
        live = RationaleGenerator(enc, sched, gpt, model, bert, gpt_tok, feats, spec=spec,
                                  micro_batch=GEN_MICRO_BATCH, max_rationale_len=GEN_MAX_LEN,
                                  device="cuda")
        timed = {}
        for name, g in (("live", live), ("aot", loaded), ("aot", loaded), ("live", live)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = g.generate(measured)
            torch.cuda.synchronize()
            timed.setdefault(name, []).append(dict(
                rows=res, seconds=time.perf_counter() - t0, launches=read_counts()))
        forwards = -(-len(measured) // GEN_MICRO_BATCH)
        per_forward = generate_launches_per_forward(enc)
        want = timed["live"][0]["rows"]
        same_tokens = all([r["rationale_ids"] for r in v["rows"]] == [r["rationale_ids"]
                                                                       for r in want]
                          for v in timed["aot"])
        same = all(v["rows"] == want for v in timed["aot"])
        check(same_tokens, "21d: the loaded generator's tokens differ from live generation")
        check(all(v["launches"]["spec_attention"] == per_forward * forwards
                  for v in timed["aot"]), f"21d: AOT launches {timed['aot'][0]['launches']}")
        http_r = generation_summary(replies, wall, {r["example_id"]: r for r in want},
                                    "serve --gen_artifact command")
        ms = {k: [1e3 * r["seconds"] / forwards for r in v] for k, v in timed.items()}
        out.update(load_in_process_s=load_s, startup_s=startup, http=http_r,
                   tokens_equal=same_tokens, replies_equal=same, ms_per_micro_batch=ms,
                   launches_per_forward=per_forward, launches=timed["aot"][0]["launches"])
        print(f"[21d aot generator] save command {out['save_command_s']:.2f} s beside 21b "
              f"and 21c (export {out['export_s']:.2f} s), program {out['program_bytes']} B, "
              f"params {out['params_bytes']} B | in-process load {load_s:.2f} s beside the "
              f"--gen_artifact command's standup, {startup:.2f} s to /healthz")
        print(f"[21d aot generator] in-process, {len(measured)} questions in {forwards} "
              f"micro-batches of {GEN_MICRO_BATCH}, {GEN_MAX_LEN} steps, in turns: ms per "
              f"micro-batch {ms} | tokens equal {same_tokens}, replies equal {same} | launches "
              f"{out['launches']} = {per_forward} x {forwards} | the command under "
              f"{GEN_CLIENTS} clients: {http_r['questions_per_s']:.2f} questions/s, p50 "
              f"{http_r['p50_ms']:.2f} ms, replies = live")
        del live, model, loaded
    finally:
        if started["proc"].poll() is None:
            started["proc"].kill()
            started["proc"].wait()
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    return out


def trace_kernel_counts(path: str) -> dict:
    """Device kernels of a Chrome trace, counted by the port's three kernel
    name prefixes."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    count = lambda prefix: sum(re.search(rf"\b{prefix}\w*_kernel", n) is not None
                               for n in names)
    return {"spec_attention": count("spec_attention"),
            "fused_attention": count("dense_attention"),
            "flash_bwd": count("flash_bwd"), "kernels": len(names)}


def profiled_fit_phase(rng) -> dict:
    """Phase 21e: ``Trainer.fit`` at phase 10's geometry with the device
    table, ``profile_dir`` (micro-steps 2 and 3 captured) and
    ``tensorboard_dir``: the trace's device kernels named spec_attention*,
    dense_attention* and flash_bwd* number 36 / 48 / 24 a profiled step,
    and the scalars are written (which writer branch ran)."""
    from multimodal_context_reasoning_torch.core.config import TrainConfig, pmr_training_config
    from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
    from multimodal_context_reasoning_torch.data.loader import DataLoader
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.trainer import Trainer

    steps, start, captured = 5, 2, 2
    cfg = pmr_training_config()
    ds = synthetic_dataset(rng, TRAIN_EXAMPLES * steps, cfg, first=250_000)
    table = DeviceFeatureTable.for_config(ds.image_features, cfg, device="cuda")
    ds.use_device_table(table)
    model = ModCRModel(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 25))
    tmp = tempfile.mkdtemp(prefix="modcr_prof_")
    try:
        trainer = Trainer(model, TrainConfig(per_device_batch_size=TRAIN_EXAMPLES,
                                             max_steps=steps, valid_steps=steps, seed=SEED),
                          DataLoader(ds, TRAIN_EXAMPLES, shuffle=True, seed=SEED),
                          profile_dir=os.path.join(tmp, "prof"), profile_start=start,
                          profile_steps=captured, tensorboard_dir=os.path.join(tmp, "tb"))
        writer = trainer.tb.writer
        reset_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        counts = trace_kernel_counts(trainer.trace_path)
        trace_bytes = os.path.getsize(trainer.trace_path)
        written = sorted(os.path.relpath(os.path.join(d, f), os.path.join(tmp, "tb"))
                         for d, _, fs in os.walk(os.path.join(tmp, "tb")) for f in fs)
    finally:
        shutil.rmtree(tmp)
    check(state.step == steps, f"21e: {state.step} steps")
    want = {k: captured * v for k, v in STEP_LAUNCHES.items()}
    got = {k: counts[k] for k in want}
    check(got == want, f"21e: the trace's kernels {got}, {want} expected")
    check(launches == {k: steps * v for k, v in STEP_LAUNCHES.items()},
          f"21e: fit launches {launches}")
    check(bool(written), "21e: no scalars written")
    print(f"[21e profile] Trainer.fit, {steps} steps of {TRAIN_EXAMPLES} examples with the "
          f"table, micro-steps {start}-{start + captured - 1} captured: trace kernels {counts} "
          f"({trace_bytes} B) = {captured} x {STEP_LAUNCHES} | fit {wall:.2f} s, launches "
          f"{launches} | TensorBoard writer: {writer}, files {written}")
    del model, state, trainer, table
    torch.cuda.empty_cache()
    return dict(trace_counts=counts, captured_steps=captured, launches=launches,
                writer=writer, files=written, trace_bytes=trace_bytes, fit_s=wall)


def phase21(rng, live_startup_s: float) -> dict:
    """Phase 21a-e; returns the summary and each kernel's additions to the
    kernels line (``aot_launches``: the AOT scorer's and generator's
    in-process runs; ``device_table_launches``: 21b's table-mode train step;
    ``op_host_us``: 21a)."""
    t21 = time.perf_counter()
    ops = ops_phase(rng)
    torch.cuda.empty_cache()
    # the generator's export runs as a process beside 21b and 21c
    gen_export = start_generator_export(rng)
    try:
        table = device_table_phase(rng)
        aot_scorer = aot_scorer_phase(rng, live_startup_s)
    except BaseException:
        gen_export["proc"].kill()
        gen_export["proc"].wait()
        shutil.rmtree(gen_export["tmp"])
        raise
    aot_generator = aot_generator_phase(gen_export)
    profiled = profiled_fit_phase(rng)
    seconds = time.perf_counter() - t21
    print(f"[21] phases 21a-21e took {seconds:.1f} s")
    aot = {k: aot_scorer["launches"][k] + aot_generator["launches"][k] for k in KERNELS}
    med = lambda row, key: statistics.median(row[key])
    host = {"spec_attention": ops["op_host_us"]}
    for k in ("fused_attention", "flash_bwd"):
        row = ops[f"{k}_host"]
        host[k] = dict(direct=med(row, "direct_host_us"), op=med(row, "op_host_us"),
                       shape=row["shape"])
    kernels = {k: dict(aot_launches=aot[k], device_table_launches=table["launches"][k],
                       op_host_us=host[k])
               for k in KERNELS}
    strip = lambda d: {k: v for k, v in d.items() if k not in ("launches", "rows")}
    return dict(kernels=kernels, summary=dict(
        ops={k: v for k, v in ops.items() if k != "host"}, ops_host=ops["host"],
        device_table={k: v for k, v in table.items() if k != "launches"},
        aot_scorer=strip(aot_scorer), aot_generator=strip(aot_generator),
        profiled_fit=profiled, phase_seconds=seconds))


# ---------------------------------------------------------------- main

class HeldSpec:
    """While active, every stage-mask forward launch is held against its
    plain version on the same inputs: per (q shape, stage) the launches and
    the worst |kernel - plain| (phase 3's tolerances)."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        from multimodal_context_reasoning_torch.ops.spec_attention import (
            fused_attention_spec,
            spec_attention_plain,
        )

        launch = fused_attention_spec.launch

        def held(q, k, v, valid, gi, rowfull, *, stage, text_len):
            got = launch(q, k, v, valid, gi, rowfull, stage=stage, text_len=text_len)
            want = spec_attention_plain(q, k, v, valid, gi, rowfull, stage=stage,
                                        text_len=text_len)
            key = (tuple(q.shape), stage, str(q.dtype))
            n, worst = self.seen.get(key, (0, 0.0))
            self.seen[key] = (n + 1, max(worst, errors(got, want)[0]))
            return got

        fused_attention_spec.launch = held
        return self

    def __exit__(self, *exc):
        from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

        del fused_attention_spec.launch
        return False


def parallel_inputs():
    """Phase 22's inputs, the same in every process: the production training
    geometry (bf16, remat, dropout 0), a global batch of PARALLEL_EXAMPLES
    examples, one micro-batch of requests and their features."""
    from multimodal_context_reasoning_torch.core.config import pmr_training_config
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_dataset,
        synthetic_requests,
    )

    cfg = pmr_training_config()
    rng = np.random.default_rng(PARALLEL_SEED)
    batch = synthetic_dataset(rng, PARALLEL_EXAMPLES, cfg, first=40_000).batch(
        np.arange(PARALLEL_EXAMPLES))
    feats, reqs = synthetic_requests(rng, SERVE_MICRO_BATCH, cfg, first=41_000)
    return cfg, batch, feats, reqs, hash_tokenizers(cfg)


def parallel_model(cfg):
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel

    return ModCRModel(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(PARALLEL_SEED))


def parallel_run(mesh, *, hold: bool = False, mesh_less: bool = False) -> dict:
    """One PMR train step of the global batch (this rank's rows) and one
    scorer micro-batch, on ``mesh`` (``mesh_less``: no mesh at all), with
    the kernel counts of each; with ``hold`` every kernel launch is held
    against its plain version (phases 3 and 7's tolerances)."""
    from multimodal_context_reasoning_torch.core.config import TrainConfig
    from multimodal_context_reasoning_torch.parallel.partition import (
        gather_tensor,
        local_rows,
        shard_module_,
    )
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.train.state import TrainState
    from multimodal_context_reasoning_torch.train.step import train_step

    cfg, batch, feats, reqs, (bert, rob) = parallel_inputs()
    model = parallel_model(cfg)
    if not mesh_less:
        shard_module_(model, mesh)
    tcfg = TrainConfig(seed=SEED)
    state = TrainState.create(model, tcfg, 10)
    local = local_rows({k: torch.from_numpy(v).cuda() for k, v in batch.items()},
                       None if mesh_less else mesh)
    spec, dense, bwd = HeldSpec(), HeldDense(), HeldBackward()
    with contextlib.ExitStack() as held:
        if hold:
            for h in (spec, dense, bwd):
                held.enter_context(h)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in train_step(state, local).items()}
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        train_counts = read_counts()
    plan = getattr(model, "tp_plan", None) or {}
    named = dict(model.named_parameters())
    params = {n: (gather_tensor(named[n].detach(), plan[n], mesh) if n in plan
                  else named[n].detach()).cpu() for n in PARALLEL_PARAMS}
    del state, model, named
    torch.cuda.empty_cache()

    scorer = ModCRScorer(cfg, parallel_model(cfg), bert, rob, feats,
                         micro_batch=SERVE_MICRO_BATCH, device="cuda",
                         mesh=None if mesh_less else mesh)
    with contextlib.ExitStack() as held:
        if hold:
            for h in (spec, dense):
                held.enter_context(h)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = scorer.score(reqs)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        score_counts = read_counts()
    del scorer
    torch.cuda.empty_cache()
    return dict(metrics=metrics, params=params, train_counts=train_counts,
                logits=[r["logits"] for r in rows], score_counts=score_counts,
                step_seconds=step_s, score_seconds=score_s,
                held_spec={f"{k[0]} {k[1]}": v for k, v in spec.seen.items()},
                held_dense={f"{k[0]} {k[1]} bias {k[3]}": v for k, v in dense.seen.items()},
                held_backward=held_backward_rows(bwd))


def parallel_rank(argv) -> int:
    """A phase-22 child: ``--parallel-rank RANK PORT DATA MODEL OUT BACKEND``
    joins a DATA x MODEL process group (gloo: every rank on card 0; nccl:
    rank r on card r) and writes parallel_run's result to OUT/rank<RANK>.pt."""
    import traceback

    import torch.distributed as dist

    from multimodal_context_reasoning_torch.parallel.mesh import make_mesh

    rank, port, d, m, out, backend = (int(argv[0]), argv[1], int(argv[2]), int(argv[3]),
                                      argv[4], argv[5])
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=d * m)
    try:
        result = parallel_run(make_mesh((d, m)), hold=True)
    except Exception:
        result = {"error": traceback.format_exc()}
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def parallel_reference() -> dict:
    """Phase 22a: world size 1 over NCCL at mesh (1, 1) against no mesh at
    all (bit-equal); returns the mesh-less run, 22b's and 22d's reference."""
    import torch.distributed as dist

    from multimodal_context_reasoning_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1))
        ref = parallel_run(None, mesh_less=True)
        one = parallel_run(mesh)
    finally:
        dist.destroy_process_group()
    same_train = (one["metrics"] == ref["metrics"]
                  and all(torch.equal(one["params"][n], ref["params"][n])
                          for n in PARALLEL_PARAMS))
    same_score = one["logits"] == ref["logits"]
    print(f"[22a ws1] NCCL world size 1, mesh (1, 1) against no mesh: train step bit-equal "
          f"{same_train} (loss {ref['metrics']['loss']:.6f}, grad norm "
          f"{ref['metrics']['grad_norm']:.6f}), scorer logits bit-equal {same_score} | "
          f"launches train {one['train_counts']} score {one['score_counts']}")
    check(same_train, "22a: the mesh (1, 1) train step differs from the mesh-less one")
    check(same_score, "22a: the mesh (1, 1) scorer differs from the mesh-less one")
    check(one["train_counts"] == STEP_LAUNCHES, f"22a: launches {one['train_counts']}")
    torch.cuda.empty_cache()
    return dict(ref, bit_equal=dict(train=same_train, score=same_score),
                mesh_launches=one["train_counts"])


def parallel_children(shape, backend: str, ref: dict) -> dict:
    """Phases 22b and 22d: one process per rank of ``shape`` over
    ``backend``, each its share of the step and the micro-batch with every
    launch held (parallel_run), held to world size 1 (PARALLEL_*_TOL)."""
    d, m = shape
    out = tempfile.mkdtemp(prefix="modcr_parallel_")
    port = str(free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), port, str(d), str(m), out, backend], cwd=ROOT)
             for r in range(d * m)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=300))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            codes.append(None)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(d * m):
        path = os.path.join(out, f"rank{r}.pt")
        ranks.append(torch.load(path, weights_only=False) if os.path.exists(path)
                     else {"error": f"no result (exit {codes[r]})"})
    shutil.rmtree(out)
    tag = f"{d}x{m} {backend}"
    for r, res in enumerate(ranks):
        check("error" not in res, f"22 {tag} rank {r}: {res.get('error')}")
    lr = 1e-5   # TrainConfig's default, the step's learning rate
    loss_err = max(abs(res["metrics"]["loss"] - ref["metrics"]["loss"]) for res in ranks)
    norm_err = max(abs(res["metrics"]["grad_norm"] / ref["metrics"]["grad_norm"] - 1)
                   for res in ranks)
    param_err = max((res["params"][n] - ref["params"][n]).abs().max().item()
                    for res in ranks for n in PARALLEL_PARAMS)
    want = np.asarray(ref["logits"])
    logit_share = max(np.abs(np.asarray(res["logits"]) - want).max()
                      for res in ranks) / np.abs(want).max()
    spec_err = max((e for res in ranks for _, e in res["held_spec"].values()), default=0.0)
    dense_err = max((e for res in ranks for _, e in res["held_dense"].values()), default=0.0)
    bwd_ok = all(backward_held_ok(res["held_backward"]) for res in ranks)
    counts = ranks[0]["train_counts"]
    where = ("processes sharing one card over gloo" if backend == "gloo"
             else "processes, one card each, over NCCL")
    print(f"[22 {tag}] {d * m} {where}: loss "
          f"{[round(res['metrics']['loss'], 6) for res in ranks]} vs ws1 "
          f"{ref['metrics']['loss']:.6f} (|Δ| {loss_err:.3e}, bound {PARALLEL_LOSS_TOL}) | "
          f"grad norm rel {norm_err:.3e} (bound {PARALLEL_NORM_TOL}) | params after the "
          f"step max |Δ| {param_err:.3e} (bound {PARALLEL_PARAM_TOL_LR} x lr) | scorer "
          f"logits max |Δ| {logit_share:.3e} of max |logit| (bound {PARALLEL_LOGIT_TOL})")
    print(f"[22 {tag}] launches rank 0 train {counts} score {ranks[0]['score_counts']} | "
          f"held: stage-mask {ranks[0]['held_spec']} dense {ranks[0]['held_dense']} | "
          f"backward {json.dumps(ranks[0]['held_backward'])}")
    print(f"[22 {tag}] seconds of {d * m} {where} (not a multi-GPU speed): step "
          f"{[round(res['step_seconds'], 3) for res in ranks]} score "
          f"{[round(res['score_seconds'], 3) for res in ranks]} | wall with start-up "
          f"{wall:.1f} s")
    check(loss_err <= PARALLEL_LOSS_TOL, f"22 {tag}: loss off by {loss_err}")
    check(norm_err <= PARALLEL_NORM_TOL, f"22 {tag}: grad norm off by {norm_err}")
    check(param_err <= PARALLEL_PARAM_TOL_LR * lr, f"22 {tag}: params off by {param_err}")
    check(logit_share <= PARALLEL_LOGIT_TOL, f"22 {tag}: logits off by {logit_share}")
    check(all(res["train_counts"] == STEP_LAUNCHES for res in ranks),
          f"22 {tag}: train launches {[res['train_counts'] for res in ranks]}")
    check(all(res["score_counts"] == ref["score_counts"] for res in ranks),
          f"22 {tag}: score launches {[res['score_counts'] for res in ranks]}")
    check(spec_err <= TOL[torch.bfloat16] and dense_err <= TOL[torch.bfloat16] and bwd_ok,
          f"22 {tag}: held kernels spec {spec_err} dense {dense_err} backward {bwd_ok}")
    return dict(loss_abs_err=loss_err, grad_norm_rel_err=norm_err, param_abs_err=param_err,
                logit_share_err=logit_share, train_launches=counts,
                score_launches=ranks[0]["score_counts"], held_spec_max_abs_err=spec_err,
                held_dense_max_rel_err=dense_err, held_backward=ranks[0]["held_backward"],
                step_seconds=[res["step_seconds"] for res in ranks],
                seconds_are=f"{d * m} {where}", wall_seconds=wall)


def phase22() -> dict:
    """Phase 22: scale-out over torch.distributed; see the module docstring."""
    from multimodal_context_reasoning_torch.cli.common import load_image_features
    from multimodal_context_reasoning_torch.data.feature_store import native_library, write_pack
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer

    t22 = time.perf_counter()
    ref = parallel_reference()
    # 22b: two processes sharing the card over gloo, meshes (2, 1) and (1, 2)
    results = {f"{d}x{m}": parallel_children((d, m), "gloo", ref)
               for d, m in PARALLEL_MESHES}

    # 22c: the smoke's features through the native .mcrpack reader
    cfg, _, feats, reqs, (bert, rob) = parallel_inputs()
    tmp = tempfile.mkdtemp(prefix="modcr_pack_")
    raw = {k: f.features for k, f in feats.items()}
    with open(os.path.join(tmp, "feats.pkl"), "wb") as f:
        pickle.dump({k: {"features": v} for k, v in raw.items()}, f)
    write_pack(raw, os.path.join(tmp, "feats.mcrpack"))
    dim = cfg.global_encoder.img_feature_dim
    logits = {}
    for name in ("feats.pkl", "feats.mcrpack"):
        source = load_image_features(os.path.join(tmp, name), dim)
        scorer = ModCRScorer(cfg, parallel_model(cfg), bert, rob, source,
                             micro_batch=SERVE_MICRO_BATCH, device="cuda")
        logits[name] = [r["logits"] for r in scorer.score(reqs)]
        if name.endswith("mcrpack"):
            native = source.native
        del scorer
    shutil.rmtree(tmp)
    same_native = logits["feats.pkl"] == logits["feats.mcrpack"]
    print(f"[22c native] .mcrpack through the native reader ({native}, "
          f"{native_library()._name}): logits equal to the pickle's {same_native}")
    check(native, "22c: the .mcrpack store did not load the native reader")
    check(same_native, "22c: native-reader logits differ from the pickle's")
    seconds = time.perf_counter() - t22
    print(f"[22] phases 22a-22c took {seconds:.1f} s")
    return dict(meshes=results, ws1_bit_equal=ref["bit_equal"],
                native_reader_equal=same_native, ws1_launches=ref["mesh_launches"],
                phase_seconds=seconds)


def phase22d() -> dict:
    """``--only 22d`` (a development aid, on a machine of 4 cards): world
    size 1 as in 22a, then mesh (2, 2) over NCCL, one process per card, held
    to it as 22b holds its processes."""
    ref = parallel_reference()
    return parallel_children((2, 2), "nccl", ref)


def main(argv=None) -> int:
    """All phases; ``--only 21`` (a development aid) runs the device and
    build phases and phase 21 alone, and prints no result line."""
    argv = sys.argv[1:] if argv is None else argv
    only = argv[1] if argv[:1] == ["--only"] else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if argv[:1] == ["--parallel-rank"]:
        return parallel_rank(argv[1:])
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.ops.build import load_library
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(card)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(load_library, KERNELS)))
    for name, (_, log, build_s) in built.items():
        ptxas = []  # per kernel instance: its name, registers and spill bytes
        for ln in log.splitlines():
            entry = re.search(r"entry function '.*?\d([a-z][a-z_]*_kernel)"
                              r"(?:I(?:Li(\d+)E)?(?:\w*?\d([A-Z][A-Za-z]*?(?:Bias|Stage)))?)?",
                              ln)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            regs = re.search(r"Used (\d+) registers", ln)
            if entry:
                args = ",".join(a for a in entry.group(2, 3) if a)
                ptxas.append(entry.group(1) + (f"<{args}>" if args else "") + ":")
            elif spill:
                ptxas.append(f"spill {spill.group(1)}/{spill.group(2)} B,")
            elif regs:
                ptxas.append(f"{regs.group(1)} regs;")
        print(f"[2 build] {name}.cu: nvcc {build_s:.2f} s | " + " ".join(ptxas))
    print(f"[2 build] all {len(KERNELS)} built and loaded in {time.perf_counter() - t0:.2f} s")
    if only == "21":
        phase21(np.random.default_rng(SEED + 21), float("nan"))
        print(card)
        return 0
    if only in ("22", "22d"):
        phase22() if only == "22" else phase22d()
        print(card)
        return 0

    # 3. kernel vs plain, at the shapes of both served micro-batches
    rng = np.random.default_rng(SEED)
    cases = {mb: shapes(rng, mb) for mb in MICRO_BATCHES}
    max_err = 0.0
    for case, _ in cases[8] + cases[32]:
        for dtype in (torch.float32, torch.bfloat16):
            args = cuda_args(case, dtype)
            kw = dict(stage=case["stage"], text_len=case["text_len"])
            got = fused_attention_spec(*args, **kw)
            torch.cuda.synchronize()
            want = spec_attention_plain(*args, **kw)
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            print(f"[3 check] {case['name']:33s} {str(dtype):15s} max|kernel-plain| "
                  f"{err:.3e} (tol {TOL[dtype]:g})")
            check(torch.isfinite(got).all().item(), f"non-finite output {case['name']}")
            check(err <= TOL[dtype], f"{case['name']} {dtype}: {err} > {TOL[dtype]}")
            del args, got, want
    masked = attention_case(rng, "fully masked rows", 4, 30, 10, 4, "chunk")
    masked["vecs"] = (torch.zeros_like(masked["vecs"][0]),) + masked["vecs"][1:]
    for dtype in (torch.float32, torch.bfloat16):
        args = cuda_args(masked, dtype)
        kw = dict(stage="chunk", text_len=masked["text_len"])
        got = fused_attention_spec(*args, **kw)
        want = spec_attention_plain(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[3 check] {'fully masked rows':33s} {str(dtype):15s} finite="
              f"{torch.isfinite(got).all().item()} max|kernel-plain| {err:.3e}")
        check(torch.isfinite(got).all().item() and err <= TOL[dtype], "fully masked rows")
    for case, _ in cases[8][1:3]:   # the chunk and full stages at L = 190
        args = cuda_args(case, torch.bfloat16)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        same = torch.equal(fused_attention_spec(*args, **kw), fused_attention_spec(*args, **kw))
        print(f"[3 check] {case['name']:33s} bf16, two launches bit-equal {same}")
        check(same, f"{case['name']}: two bf16 launches differ")

    # 4. timing (bf16, the serving dtype), at micro-batch 8
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, b2b_ms=0.0,
                  library_b2b_ms=0.0)
    bytes_share = 0.0
    per_shape = []
    for case, n_fwd in cases[8]:
        args = cuda_args(case, torch.bfloat16)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        kernel = lambda: fused_attention_spec(*args, **kw)
        sdpa = sdpa_call(*args, case)
        ms = median_ms(kernel)
        plain_ms = median_ms(lambda: spec_attention_plain(*args, **kw))
        lib_ms = median_ms(sdpa)
        b2b_ms, lib_b2b_ms = back_to_back_ms(kernel), back_to_back_ms(sdpa)
        b_ms, b_by = bound(case, torch.bfloat16)
        per_shape.append(dict(shape=case["name"], launches_per_forward=n_fwd, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by, b2b_ms=b2b_ms, library_b2b_ms=lib_b2b_ms))
        print(f"[4 time] {case['name']:33s} kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"sdpa {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | "
              f"{n_fwd} per forward")
        print(f"[4 time] {case['name']:33s} 25 back to back, per launch: kernel "
              f"{b2b_ms:.4f} ms ({b_ms / b2b_ms:.2%} of its bound) | sdpa {lib_b2b_ms:.4f} ms "
              f"| kernel / sdpa {b2b_ms / lib_b2b_ms:.2f}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("library_ms", lib_ms), ("b2b_ms", b2b_ms),
                         ("library_b2b_ms", lib_b2b_ms)):
            totals[key] += n_fwd * val
        if b_by == "bytes":
            bytes_share += n_fwd * b_ms
    print("[4 time] one micro-batch-8 forward's 60 launches: " + " | ".join(
        f"{k} {v:.4f}" for k, v in totals.items()))
    train_spec = time_training_spec_shapes(rng)

    # 5. end-to-end parity, full width fp32: card (kernel) vs CPU (plain)
    # serving needs logits only: no alignment loss, so no layer returns
    # probabilities and every attention with a mask spec takes the kernel
    cfg32 = dataclasses.replace(ModCRConfig(), compute_alignment=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = ModCRModel(cfg32, device="cuda", generator=gen)
    cpu_model = copy.deepcopy(model).cpu()
    bert, rob = hash_tokenizers(cfg32)
    parity_feats, parity_reqs = synthetic_requests(rng, 1, cfg32)
    gpu_rows = ModCRScorer(cfg32, model, bert, rob, parity_feats, micro_batch=1,
                           device="cuda").score(parity_reqs)
    t0 = time.perf_counter()
    cpu_rows = ModCRScorer(cfg32, cpu_model, bert, rob, parity_feats, micro_batch=1,
                           device="cpu").score(parity_reqs)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    g, c = np.asarray(gpu_rows[0]["logits"]), np.asarray(cpu_rows[0]["logits"])
    e2e_err = float(np.abs(g - c).max())
    print(f"[5 parity] full-width fp32, 1 example (4 rows): cuda {np.round(g, 5).tolist()} "
          f"cpu {np.round(c, 5).tolist()} max|diff| {e2e_err:.3e} (tol 1e-3) | "
          f"pred {gpu_rows[0]['prediction']} vs {cpu_rows[0]['prediction']} | "
          f"cpu forward {cpu_s:.1f} s")
    check(np.isfinite(g).all() and e2e_err <= 1e-3, "end-to-end logits disagree")
    check(gpu_rows[0]["prediction"] == cpu_rows[0]["prediction"], "predictions differ")

    # 6. serving, the main path: full-width bf16 scorer, same weights
    cfg16 = cfg32.with_dtype("bfloat16")
    model16 = ModCRModel(cfg16, device="cuda")
    model16.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    reset_counts()
    forwards = 0
    serving = {}
    for mb, n_chunks in zip(MICRO_BATCHES, (8, 4)):
        feats, reqs = synthetic_requests(rng, mb * (n_chunks + 1), cfg16, first=1000 * mb)
        scorer = ModCRScorer(cfg16, model16, bert, rob, feats, micro_batch=mb,
                             device="cuda")
        before = fused_attention_spec.launches
        rows = scorer.score(reqs[:mb])  # warm-up micro-batch
        forwards += 1
        check(fused_attention_spec.launches - before == LAUNCHES_PER_FORWARD,
              f"mb {mb}: {fused_attention_spec.launches - before} launches in one forward")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = scorer.score(reqs[mb:])
        wall = time.perf_counter() - t0
        forwards += n_chunks
        logits = np.asarray([r["logits"] for r in rows])
        check(logits.shape == (mb * n_chunks, cfg16.num_labels), f"logits {logits.shape}")
        check(np.isfinite(logits).all(), f"non-finite bf16 logits at mb {mb}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        serving[mb] = dict(examples_per_s=len(rows) / wall,
                           ms_per_micro_batch=1e3 * wall / n_chunks, peak_gib=peak)
        print(f"[6 serve] bf16 micro_batch {mb} ({mb * cfg16.num_labels} rows): "
              f"{len(rows)} examples in {wall:.3f} s = {len(rows) / wall:.2f} ex/s, "
              f"{1e3 * wall / n_chunks:.2f} ms per micro-batch, peak {peak:.2f} GiB "
              f"(host featurize included)")
    serve_counts = read_counts()
    launches = serve_counts["spec_attention"]
    print(f"[6 serve] {forwards} forwards, launches {serve_counts} "
          f"(spec_attention = {LAUNCHES_PER_FORWARD} x {forwards})")
    check(launches == LAUNCHES_PER_FORWARD * forwards, "launch count on the serving path")
    bf16_logits = np.asarray(ModCRScorer(
        cfg16, model16, bert, rob, parity_feats, micro_batch=1, device="cuda",
    ).score(parity_reqs)[0]["logits"])
    print(f"[6 serve] phase-5 request in bf16: {np.round(bf16_logits, 5).tolist()}, "
          f"max|bf16-fp32| {np.abs(bf16_logits - g).max():.3e} (not a check)")
    del model16, scorer
    torch.cuda.empty_cache()

    # 7-8. the training kernels against their plain versions, then timed
    train_err = check_training_kernels(rng)
    train_times = time_training_kernels(rng)
    torch.cuda.empty_cache()

    # 9. training parity, card against CPU
    parity = training_parity(rng)
    torch.cuda.empty_cache()

    # 10. training, the slice's main path
    train = train_slice(rng)
    torch.cuda.empty_cache()

    # 12. the two commands at full width (before 11's closing lines)
    cli = cli_phase(rng)
    torch.cuda.empty_cache()

    # 13. every route at long keys
    long_keys = long_key_phase(rng)
    torch.cuda.empty_cache()

    # 14. the serve command, the slice's main path
    served = serve_phase(rng)
    torch.cuda.empty_cache()

    # 15. W8A8 int8: the products, the scorer, the command
    int8 = dict(products=int8_products(rng), scoring=int8_scoring(rng), command=int8_command(rng))

    # 16. /generate, the rationale family
    generated = generate_phase(rng)
    torch.cuda.empty_cache()

    # 17. beam and CBS at full width; 18. rationale training at full width
    # and the backward at its encoder shape
    beam_cbs = beam_cbs_phase(rng)
    rationale = rationale_train_phase(rng)
    encoder_bwd = time_encoder_backward(rng)

    # 19. the two-stage recipe: stage-1 parity, the command at full width,
    # then the kernels on the inputs of one more stage-1 step
    t19 = time.perf_counter()
    stage1_parity_r = stage1_parity(rng)
    two_stage = two_stage_phase(rng)
    held = two_stage.pop("held")
    stage1_kernels = time_stage1_kernels(held["held"], held["spec"],
                                         two_stage["stage1_launches_per_step"]["flash_bwd"])
    del held
    two_stage.update(parity=stage1_parity_r, backward_held=stage1_kernels["held"],
                     phase_seconds=time.perf_counter() - t19)
    print(f"[19] phases 19a-19c took {two_stage['phase_seconds']:.1f} s")

    # 20. the ensembles and CLIP: parity, the ensemble path (counted), the
    # CLIP towers and ensembles, the precompute command, the kernel at
    # RoBERTa's no-prefix shape
    t20 = time.perf_counter()
    ensemble_parity_r = ensemble_parity(rng)
    ensembles, kept, heads = ensemble_path(
        rng, serving[ENSEMBLE_QUESTIONS]["ms_per_micro_batch"])
    clip = clip_path(rng, heads)
    clip["command"] = clip_command(rng)
    no_prefix = roberta_no_prefix_kernels(kept)
    del kept, heads
    ensembles.update(parity=ensemble_parity_r, phase_seconds=time.perf_counter() - t20)
    print(f"[20] phases 20a-20e took {ensembles['phase_seconds']:.1f} s")

    # 21. the kernels as ops, the device table, the AOT artifacts, the
    # profiled and logged trainer
    standalone = phase21(rng, served["http_command"]["startup_s"])

    # 22. scale-out: world size 1 over NCCL, two processes on the card over
    # gloo at meshes (2, 1) and (1, 2), the native .mcrpack reader
    parallel = phase22()

    # 11. kernels line, then the result line
    print(card)
    print(json.dumps({"serving": serving, "e2e_fp32_max_abs_diff": e2e_err,
                      "train_parity_max_rel_diff": parity["max_rel_diff"],
                      "training": {k: v for k, v in train.items() if k != "launches"},
                      "cli": {k: v for k, v in cli.items() if k != "launches"},
                      "serve": {k: v for k, v in served.items() if k != "launches"},
                      "int8": int8,
                      "generate": {k: v for k, v in generated.items() if k != "launches"},
                      "beam_cbs": {k: v for k, v in beam_cbs.items() if k != "launches"},
                      "rationale_train": {k: v for k, v in rationale.items()
                                          if k != "launches"},
                      "two_stage": {k: v for k, v in two_stage.items() if k != "launches"},
                      "ensembles": {k: v for k, v in ensembles.items() if k != "launches"},
                      "clip": clip,
                      "standalone": standalone["summary"],
                      "parallel": parallel}))
    parallel_launches = {k: {tag: r["train_launches"][k] for tag, r in parallel["meshes"].items()}
                         for k in KERNELS}
    main_path = train["launches"]
    shape = "bf16 (128, 128, 138, 16, 64), one launch, as one RoBERTa layer of the slice"

    def long_key_row(name):
        return dict(largest_lk=long_keys["largest_lk"],
                    max_abs_err=long_keys["max_abs_err"][name], timed=long_keys["timed"][name])
    print(json.dumps({"kernels": [{
        "name": "spec_attention",
        "route": "cuda",
        "source": "multimodal_context_reasoning_torch/csrc/spec_attention.cu",
        "replaces": "multimodal_context_reasoning_tpu/ops/pallas_attention.py:187",
        "launches": main_path["spec_attention"],
        "serving_launches": launches,
        "cli_launches": cli["launches"]["spec_attention"],
        "serve_launches": served["launches"]["spec_attention"],
        "int8_launches": int8["scoring"]["launches"],
        "generate_launches": generated["launches"],
        "beam_cbs_launches": beam_cbs["launches"]["spec_attention"],
        "rationale_train_launches": rationale["launches"]["spec_attention"],
        "stage1_launches": two_stage["stage1_launches"]["spec_attention"],
        "two_stage_launches": two_stage["launches"]["spec_attention"],
        "ensemble_launches": ensembles["launches"]["spec_attention"],
        **standalone["kernels"]["spec_attention"],
        "parallel_launches": parallel_launches["spec_attention"],
        "max_abs_err": max(max_err, train_err["spec_attention"],
                           long_keys["max_abs_err"]["spec_attention"],
                           *(r["max_abs_err"] for r in stage1_kernels["forward"]
                             + no_prefix["spec"])),
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if bytes_share >= totals["bound_ms"] / 2 else "operations",
        "library_ms": totals["library_ms"],
        "b2b_ms": totals["b2b_ms"],
        "library_b2b_ms": totals["library_b2b_ms"],
        "timed_as": "sum over one micro-batch-8 forward's 60 launches, bf16 (ms, plain_ms, "
                    "library_ms per call; b2b_ms, library_b2b_ms back to back)",
        "shapes": per_shape,
        "training_shapes": train_spec,
        "long_keys": long_key_row("spec_attention"),
        "encoder_shapes": stage1_kernels["forward"],
        "roberta_no_prefix": no_prefix["spec"],
    }, {
        "name": "fused_attention",
        "route": "cuda",
        "source": "multimodal_context_reasoning_torch/csrc/fused_attention.cu",
        "replaces": "multimodal_context_reasoning_tpu/ops/pallas_attention.py:73",
        "launches": main_path["fused_attention"],
        "cli_launches": cli["launches"]["fused_attention"],
        "serve_launches": served["launches"]["fused_attention"],
        "stage1_launches": two_stage["stage1_launches"]["fused_attention"],
        "two_stage_launches": two_stage["launches"]["fused_attention"],
        "ensemble_launches": ensembles["launches"]["fused_attention"],
        **standalone["kernels"]["fused_attention"],
        "parallel_launches": parallel_launches["fused_attention"],
        "max_abs_err": max(train_err["fused_attention"],
                           long_keys["max_abs_err"]["fused_attention"],
                           *(r["max_abs_err"] for r in no_prefix["dense"])),
        **train_times["fused_attention"],
        "timed_as": shape,
        "long_keys": long_key_row("fused_attention"),
        "roberta_no_prefix": no_prefix["dense"],
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "multimodal_context_reasoning_torch/csrc/flash_bwd.cu",
        "replaces": "multimodal_context_reasoning_tpu/ops/flash.py:190",
        "launches": main_path["flash_bwd"],
        "cli_launches": cli["launches"]["flash_bwd"],
        "serve_launches": served["launches"]["flash_bwd"],
        "rationale_train_launches": rationale["launches"]["flash_bwd"],
        "stage1_launches": two_stage["stage1_launches"]["flash_bwd"],
        "two_stage_launches": two_stage["launches"]["flash_bwd"],
        "ensemble_launches": ensembles["launches"]["flash_bwd"],
        **standalone["kernels"]["flash_bwd"],
        "parallel_launches": parallel_launches["flash_bwd"],
        "max_abs_err": max(train_err["flash_bwd"], long_keys["max_abs_err"]["flash_bwd"],
                           *(r["max_abs_err"] for r in encoder_bwd + stage1_kernels["backward"]
                             + no_prefix["backward"])),
        **train_times["flash_bwd"],
        "timed_as": shape + ", no dbias plane",
        "long_keys": long_key_row("flash_bwd"),
        "encoder_shapes": encoder_bwd + stage1_kernels["backward"],
        "roberta_no_prefix": no_prefix["backward"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
