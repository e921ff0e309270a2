"""PyTorch port, scale-out (``parallel/``): the partition rules against the
JAX package's, and two-process gloo runs on the CPU against one process.

- Every parameter of the tiny ModCR and of the tiny rationale model gets
  the split that JAX's ``_spec_for`` gives its JAX counterpart, matched
  through ``interop/from_jax.py`` (a column-parallel bias is split in the
  port, where JAX keeps it whole and XLA slices it).
- Two ranks over gloo (tests/torch_parallel_worker.py, launched as
  subprocesses as JAX tests/test_multihost.py does), at meshes (2, 1) and
  (1, 2) over the one process group, take three PMR train steps on weights
  carried from the JAX init; JAX's single-device ``make_train_step`` on the
  same global batches is the reference, with losses at JAX's
  ``dryrun_multichip`` bound (rtol 1e-4, atol 1e-5, __graft_entry__.py:239)
  and every parameter within 2e-4 of the largest |parameter|.  The mesh
  scorer and generator are held against one port process on the same
  inputs (logits and probabilities 1e-5, tokens exactly; the int8 scorer
  as tests/test_torch_quant.py holds int8), a checkpoint saved at (1, 2)
  resumes at (2, 1) and on one process as an uninterrupted run, divergent
  device tables raise on both ranks, a step with dropout on leaves the
  replicated parameters bit-equal across the model group, and a mesh
  larger than the world is refused.  ``run_pmr --multihost`` trains at
  ``--mesh_model 2`` and tests at ``--mesh_data 2`` in that process group:
  the same checkpoint (within the parameter bound) and the same prediction
  file as one process.
- ``DataLoader(shard=...)`` yields the JAX loader's order.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ChunkAlignConfig as JSched
from multimodal_context_reasoning_tpu.core.config import EncoderConfig as JEnc
from multimodal_context_reasoning_tpu.core.config import GPT2Config as JGPT2
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_context_reasoning_tpu.data.loader import DataLoader as JLoader
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.models.rationale import RationaleModel as JRationale
from multimodal_context_reasoning_tpu.models.rationale import rationale_init_batch
from multimodal_context_reasoning_tpu.parallel.partition import _spec_for
from multimodal_context_reasoning_tpu.train import optim as joptim
from multimodal_context_reasoning_tpu.train.state import TrainState as JState
from multimodal_context_reasoning_tpu.train.step import make_train_step
from multimodal_context_reasoning_torch.cli import run_pmr as trun_pmr
from multimodal_context_reasoning_torch.core.config import ChunkAlignConfig as TSched
from multimodal_context_reasoning_torch.core.config import EncoderConfig as TEnc
from multimodal_context_reasoning_torch.core.config import GPT2Config as TGPT2
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
from multimodal_context_reasoning_torch.interop.from_jax import (
    params_from_jax,
    rationale_params_from_jax,
)
from multimodal_context_reasoning_torch.models.gpt2 import Conv1D
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.models.rationale import RationaleModel
from multimodal_context_reasoning_torch.parallel import make_mesh, mesh_shape_for
from multimodal_context_reasoning_torch.parallel.partition import plan_for
from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
from multimodal_context_reasoning_torch.serving.synthetic import (
    hash_tokenizers,
    region_features,
    synthetic_requests,
    task_rows,
    write_rows,
)
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import train_step
from tests.test_torch_models import make_batch
from tests.test_torch_quant import assert_int8_close

TRAJ = dict(rtol=1e-4, atol=1e-5)
PARAM_SHARE = 2e-4
TCFG = dict(learning_rate=1e-3, scheduler="linear", warmup_steps=1, weight_decay=0.01)
TOTAL_STEPS = 10
MESHES = [(2, 1), (1, 2)]
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
ENC_KW = dict(vocab_size=256, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
              intermediate_size=64, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, max_position_embeddings=128,
              img_feature_dim=20)
GPT2_KW = dict(vocab_size=128, n_positions=96, n_embd=32, n_layer=2, n_head=4,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, pad_token_id=0)
SCHED_KW = dict(chunk_layers_end=1, full_layers_end=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the test off the cores the other workers
    use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls):
    return dataclasses.replace(cls.tiny(), mapping_dropout=0.0)


def _port_models():
    tcfgs = TEnc(**ENC_KW), TSched(**SCHED_KW), TGPT2(**GPT2_KW)
    return {"modcr": TModel(_cfg(TConfig), device="cpu"),
            "rationale": RationaleModel(*tcfgs, max_chunks=8, device="cpu")}


PORT_NAMES = [(kind, name) for kind, model in _port_models().items()
              for name, _ in model.named_parameters()]


# ---------------------------------------------------------------- the rules

_CODES = {(): 0.0, (None, "model"): 1.0, ("model", None): 2.0}


def _marked(shapes):
    """Each JAX leaf filled with the code of the spec JAX's rules give it."""
    def mark(path, leaf):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        return np.full(leaf.shape, _CODES[tuple(_spec_for(name, len(leaf.shape)))],
                       np.float32)
    return jax.tree_util.tree_map_with_path(mark, shapes)


@pytest.fixture(scope="module")
def jax_specs():
    """Port parameter name -> the code of its JAX counterpart's spec."""
    jcfg = _cfg(JConfig)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0), make_batch(jcfg))
    modcr = params_from_jax(_marked(shapes), _cfg(TConfig))
    enc, gpt = JEnc(**ENC_KW), JGPT2(**GPT2_KW)
    init = rationale_init_batch(enc, gpt, JConfig.tiny())
    rshapes = jax.eval_shape(JRationale(enc, JSched(**SCHED_KW), gpt, max_chunks=8).init,
                             jax.random.PRNGKey(0), init)
    rationale = rationale_params_from_jax(_marked(rshapes), TEnc(**ENC_KW), TGPT2(**GPT2_KW))
    models = _port_models()
    return {kind: (sd, dict(models[kind].named_modules()), plan_for(models[kind])[0])
            for kind, sd in (("modcr", modcr), ("rationale", rationale))}


@pytest.mark.parametrize("kind,name", PORT_NAMES, ids=[f"{k}:{n}" for k, n in PORT_NAMES])
def test_partition_rule_matches_jax(jax_specs, kind, name):
    marked, modules, plan = jax_specs[kind]
    codes = torch.unique(marked[name])
    assert codes.numel() == 1, (name, codes)   # fused q/k/v parts agree
    code = float(codes)
    path, leaf = name.rsplit(".", 1)
    layer = modules.get(path)
    # the JAX code of a weight in the port's layout: Conv1D keeps [in, out]
    out_dim = 1 if isinstance(layer, Conv1D) else 0
    if leaf == "bias" and name in plan:
        # split with its column-parallel weight (JAX: whole, sliced by XLA)
        assert code == 0.0
        assert float(torch.unique(marked[f"{path}.weight"])) == 1.0
        assert plan[name].dim == 0
    elif code == 0.0:
        assert name not in plan
    else:
        want = out_dim if code == 1.0 else 1 - out_dim
        assert plan[name].dim == want


# ------------------------------------------------------- two-process runs

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(directory):
    """Start both ranks of the worker; returns the processes."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.getcwd())
    return [subprocess.Popen([sys.executable, WORKER, str(rank), str(port), str(directory)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(2)]


def _collect(procs, directory, timeout=150):
    outs = []
    for rank, p in enumerate(procs):
        try:
            log = p.communicate(timeout=timeout)[0].decode(errors="replace")
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {rank} timed out")
        path = os.path.join(directory, f"rank{rank}.pt")
        assert os.path.exists(path), log[-3000:]
        out = torch.load(path, weights_only=False)
        assert "error" not in out, out.get("error")
        outs.append(out)
    return outs


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_steps(jcfg, params, batches, steps):
    model = JModel(jcfg)
    tx = joptim.make_optimizer(JTrainConfig(**TCFG), TOTAL_STEPS, params)
    state = JState.create(params, tx)
    step = make_train_step(model, donate=False)
    metrics = []
    for i in range(steps):
        state, m = step(state, batches[i], jax.random.PRNGKey(100 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state.params), metrics


def _port_steps(cfg, init, batches):
    model = TModel(cfg, device="cpu")
    model.load_state_dict(init, strict=True)
    state = TrainState.create(model, TrainConfig(**TCFG), TOTAL_STEPS)
    metrics = [{k: float(v) for k, v in train_step(state, _t(b)).items()} for b in batches]
    return state, metrics


def _generator(g, feats, bert, mesh=None):
    model = RationaleModel(*g["cfgs"], max_chunks=8, device="cpu")
    model.load_state_dict(g["weights"], strict=True)
    return RationaleGenerator(*g["cfgs"], model, bert, g["gpt_tok"], feats, spec=g["spec"],
                              max_chunks=8, micro_batch=2, max_rationale_len=6,
                              device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written once, then the two ranks run both meshes and the
    resume; JAX and one port process compute the references meanwhile."""
    directory = tmp_path_factory.mktemp("parallel")
    jcfg, cfg = _cfg(JConfig), _cfg(TConfig)
    batches = [make_batch(jcfg, n_examples=4, seed=s) for s in range(5)]
    start = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0), batches[0])
    init = params_from_jax(jax.tree.map(np.asarray, start), cfg)

    score_cfg = dataclasses.replace(cfg, compute_alignment=False)
    rng = np.random.default_rng(5)
    feats, requests = synthetic_requests(rng, 4, score_cfg)
    bert, rob = hash_tokenizers(score_cfg)
    tcfgs = TEnc(**ENC_KW), TSched(**SCHED_KW), TGPT2(**GPT2_KW)
    rmodel = RationaleModel(*tcfgs, max_chunks=8, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    gen = dict(cfgs=tcfgs, weights=rmodel.state_dict(), gpt_tok=HashTokenizer(vocab_size=128),
               spec=BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len,
                              roberta_len=cfg.roberta_len,
                              img_feature_dim=ENC_KW["img_feature_dim"]))
    rows = {name: task_rows(rng, n, cfg.img_len, first=first, words=(1, 4))
            for name, n, first in (("train", 8, 0), ("val", 4, 100), ("test", 6, 200))}
    for name, r in rows.items():
        write_rows(str(directory / f"{name}.jsonl"), r)
    with open(directory / "feats.pkl", "wb") as f:
        pickle.dump({k: {"features": v} for k, v in region_features(
            rng, sum(rows.values(), []), cfg.img_len, ENC_KW["img_feature_dim"]).items()}, f)
    cli_argv = ["--device", "cpu", "--tiny", "--compute_dtype", "float32",
                "--per_gpu_train_batch_size", "2", "--per_gpu_eval_batch_size", "2",
                "--max_steps", "3", "--learning_rate", "1e-3", "--valid_steps", "1",
                "--epoch_begin", "0", "--img_feat_file", str(directory / "feats.pkl"),
                "--train_file", str(directory / "train.jsonl"),
                "--val_file", str(directory / "val.jsonl"),
                "--test_file", str(directory / "test.jsonl")]
    torch.save(dict(cfg=cfg, init=init, tcfg=TCFG, total_steps=TOTAL_STEPS,
                    batches=[_t(b) for b in batches], score_cfg=score_cfg, feats=feats,
                    requests=requests, bert=bert, rob=rob, gen=gen, cli_argv=cli_argv),
               directory / "inputs.pt")
    procs = _launch(directory)

    # meanwhile: JAX's three steps, and one port process's five uninterrupted
    # steps, scorer and generator
    end, jmetrics = _jax_steps(jcfg, start, batches, 3)
    state, metrics = _port_steps(cfg, init, batches)
    uninterrupted = dict(metrics=metrics, params=state.model.state_dict())
    scores = ModCRScorer(score_cfg, init, bert, rob, feats, micro_batch=2, device="cpu",
                         use_device_table=True).score(requests)
    int8_scores = ModCRScorer(score_cfg.with_quantize("int8"), init, bert, rob, feats,
                              micro_batch=2, device="cpu").score(requests)
    generated = _generator(gen, feats, bert).generate(requests)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TConfig, "tiny", classmethod(
            lambda c, tiny=TConfig.tiny: dataclasses.replace(tiny(), mapping_dropout=0.0)))
        trun_pmr.main(cli_argv + ["--do_train", "--output_dir", str(directory / "one_train")])
        trun_pmr.main(cli_argv + ["--do_test", "--eval_model_dir", str(directory / "one_train"),
                                  "--output_dir", str(directory / "one_test")])

    ranks = _collect(procs, directory)
    mesh = {shape: [out[shape] for out in ranks] for shape in MESHES}
    resumed = [out["resume"] for out in ranks]

    # one process restores the (1, 2) checkpoint and goes on
    model = TModel(cfg, device="cpu")
    one = TrainState.create(model, TrainConfig(**TCFG), TOTAL_STEPS)
    CheckpointManager(str(directory / "ckpt")).restore(one)
    one_metrics = [{k: float(v) for k, v in train_step(one, _t(b)).items()}
                   for b in batches[3:5]]
    return dict(dir=directory, cfg=cfg, jax_end=end, jax_metrics=jmetrics, mesh=mesh,
                scores=scores, int8_scores=int8_scores,
                generated=generated, uninterrupted=uninterrupted, resumed=resumed,
                one=dict(metrics=one_metrics, params=one.model.state_dict(), step=one.step))


def _assert_params_close(got, want):
    """Every parameter within ``PARAM_SHARE`` of the largest |parameter|."""
    assert set(got) == set(want)
    tol = PARAM_SHARE * max(float(w.float().abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((got[name].float() - w.float()).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2"])
def test_mesh_train_steps_match_jax_single_device(runs, shape):
    ranks = runs["mesh"][shape]
    for key in ("loss", "grad_norm", "correct", "count"):
        want = [m[key] for m in runs["jax_metrics"]]
        for out in ranks:
            np.testing.assert_allclose([m[key] for m in out["metrics"]], want, **TRAJ,
                                       err_msg=f"{shape} {key}")
    want = params_from_jax(runs["jax_end"], runs["cfg"])
    _assert_params_close(ranks[0]["params"], want)


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2"])
def test_mesh_scorer_equals_one_process(runs, shape):
    for out in runs["mesh"][shape]:
        got, want = out["scores"], runs["scores"]
        assert [r["example_id"] for r in got] == [r["example_id"] for r in want]
        assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
        np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want],
                                   rtol=0, atol=1e-5)
    errs = [out["score_micro_batch_error"] for out in runs["mesh"][shape]]
    if shape[0] == 2:
        assert all("must divide micro_batch=1 examples" in e for e in errs), errs
    else:
        assert errs == ["", ""]


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2"])
def test_mesh_int8_scorer_matches_one_process(runs, shape):
    """Row-parallel int8 products take their scales over the whole input
    (a MAX all-reduce) and sum the int32 accumulators: one process's codes,
    up to the flips the fp32 layers' other summation order can cause."""
    for out in runs["mesh"][shape]:
        assert_int8_close([r["logits"] for r in out["int8_scores"]],
                          [r["logits"] for r in runs["int8_scores"]])


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2"])
def test_mesh_generator_equals_one_process(runs, shape):
    for out in runs["mesh"][shape]:
        got, want = out["generated"], runs["generated"]
        np.testing.assert_allclose([r["probs"] for r in got], [r["probs"] for r in want],
                                   rtol=0, atol=1e-5)
        assert [r["rationale_ids"] for r in got] == [r["rationale_ids"] for r in want]
        for g, w in zip(got, want):
            top2 = np.sort(w["probs"])[-2:]
            if top2[1] - top2[0] > 2e-5:    # a near-tie may go either way
                assert g["prediction"] == w["prediction"]


def test_tp_checkpoint_resumes_at_2x1_and_on_one_process(runs):
    want = runs["uninterrupted"]
    for out in runs["resumed"]:
        assert (out["restored_step"], out["restored_count"]) == (3, 3)
    for got in (runs["resumed"][0], runs["one"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([m[key] for m in got["metrics"]],
                                       [m[key] for m in want["metrics"][3:5]], **TRAJ)
        _assert_params_close(got["params"], want["params"])
    assert runs["one"]["step"] == 5


def test_run_pmr_multihost_equals_one_process(runs):
    d = runs["dir"]
    got = CheckpointManager(str(d / "mesh_train" / "ckpt")).restore_params(best=True)
    want = CheckpointManager(str(d / "one_train" / "ckpt")).restore_params(best=True)
    _assert_params_close(got, want)
    name = "result_test_ModICR_pmr.json"
    lines = (d / "mesh_test" / name).read_text().splitlines()
    assert lines == (d / "one_test" / name).read_text().splitlines() and len(lines) == 6


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2"])
def test_divergent_device_tables_raise_on_both_ranks(runs, shape):
    for out in runs["mesh"][shape]:
        assert "differs across hosts" in out["divergent_table_error"]


def test_dropout_keeps_replicated_parameters_equal_across_the_model_group(runs):
    r0, r1 = runs["mesh"][(1, 2)]
    assert all(np.isfinite(m["loss"]) for m in r0["dropout_metrics"])
    assert r0["replicated_digests"] and r0["replicated_digests"] == r1["replicated_digests"]


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2"])
def test_mesh_larger_than_the_world_is_refused(runs, shape):
    for out in runs["mesh"][shape]:
        assert "!= 2 processes" in out["too_large_error"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="needs an initialised torch.distributed"):
        make_mesh((2, 1))
    with pytest.raises(ValueError, match="not divisible by model_parallelism=3"):
        mesh_shape_for(4, 3)
    assert mesh_shape_for(8, 2) == (4, 2)


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, idx):
        return {"idx": np.asarray(idx, np.int64)}


@pytest.mark.parametrize("n,count,drop_last,shuffle",
                         [(13, 2, False, True), (13, 2, True, True), (12, 3, False, False),
                          (7, 2, False, False)])
def test_sharded_loader_order_equals_jax(n, count, drop_last, shuffle):
    for idx in range(count):
        kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, prefetch=False,
                  shard=(idx, count))
        got = list(DataLoader(_Rows(n), 3, **kw))
        want = list(JLoader(_Rows(n), 3, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["idx"], w["idx"])
            np.testing.assert_array_equal(g["example_mask"], w["example_mask"])
