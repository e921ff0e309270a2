"""PyTorch port, training: the optimizer, the schedules, the accumulator,
the train step, the data loader, checkpoints and the trainer, held against
the JAX package at ``ModCRConfig.tiny()`` with every dropout at 0, the JAX
weights carried across by ``params_from_jax`` and the same numpy batch on
both sides.

The trajectory tests run the slice's configuration (``compute_alignment``
off, ``mem_efficient_attention`` on): four steps of JAX ``make_train_step``
with ``remat=True``, against four port steps with the dense-bias remat
branch and four with the stage-mask branch (``remat=False``).  JAX's remat
is a scheduling choice that leaves its numbers as they are
(tests/test_train.py::TestRematEquivalence), so one JAX trajectory is the
reference of both.  Losses and gradient norms agree to rtol 1e-4 / atol
1e-5, as tests/test_flash.py holds its two trajectories."""

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_context_reasoning_tpu.data import collate as jcollate
from multimodal_context_reasoning_tpu.data import pmr as jpmr
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.data.loader import DataLoader as JLoader
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.train import optim as joptim
from multimodal_context_reasoning_tpu.train.state import TrainState as JState
from multimodal_context_reasoning_tpu.train.step import make_train_step
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.core.config import TrainConfig, pmr_training_config
from multimodal_context_reasoning_torch.data import collate as tcollate
from multimodal_context_reasoning_torch.data import pmr as tpmr
from multimodal_context_reasoning_torch.data import schemas as tschemas
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
from multimodal_context_reasoning_torch.train import optim as toptim
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager, save_config
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import eval_step, train_step
from multimodal_context_reasoning_torch.train.trainer import Trainer
from tests.test_torch_models import make_batch

TRAJ = dict(rtol=1e-4, atol=1e-5)
STEPS = 4
TCFG = dict(learning_rate=1e-3, scheduler="linear", warmup_steps=1, weight_decay=0.01)
TOTAL_STEPS = 10


def _slice_config(cls, remat: bool, dtype: str = "float32"):
    base = cls.tiny()
    cfg = dataclasses.replace(
        base, compute_alignment=False, mapping_dropout=0.0,
        roberta=dataclasses.replace(base.roberta, remat=remat,
                                    mem_efficient_attention=True))
    return cfg.with_dtype(dtype)


def _batch(cfg):
    batch = make_batch(cfg)
    batch["label"][cfg.num_labels + 2] = 1.0   # example 1 has two gold candidates
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_run(dtype: str, steps: int):
    cfg = _slice_config(JConfig, remat=True, dtype=dtype)
    batch = _batch(cfg)
    model = JModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    tx = joptim.make_optimizer(JTrainConfig(**TCFG), TOTAL_STEPS, params)
    state = JState.create(params, tx)
    step = make_train_step(model, donate=False)
    metrics = []
    for i in range(steps):
        state, m = step(state, batch, jax.random.PRNGKey(100 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return dict(batch=batch, start=to_np(params), end=to_np(state.params), metrics=metrics)


def _port_run(jax_run, remat: bool, dtype: str = "float32"):
    cfg = _slice_config(TConfig, remat=remat, dtype=dtype)
    model = TModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax_run["start"], cfg), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, TrainConfig(**TCFG), TOTAL_STEPS)
    batch = _t(jax_run["batch"])
    metrics = [{k: float(v) for k, v in train_step(state, batch).items()}
               for _ in range(len(jax_run["metrics"]))]
    return dict(model=model, state=state, start=start, metrics=metrics, cfg=cfg)


@pytest.fixture(scope="module")
def jax_fp32():
    return _jax_run("float32", STEPS)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_trajectory_matches_jax(jax_fp32, remat):
    port = _port_run(jax_fp32, remat)
    for key in ("loss", "grad_norm", "correct", "count"):
        np.testing.assert_allclose([m[key] for m in port["metrics"]],
                                   [m[key] for m in jax_fp32["metrics"]], **TRAJ,
                                   err_msg=key)
    assert port["state"].step == STEPS and port["state"].optimizer.count == STEPS
    want = params_from_jax(jax_fp32["end"], port["cfg"])
    labels = toptim.label_params(want)
    got = port["model"].state_dict()
    for name, w in want.items():
        if labels[name] == "frozen":
            assert torch.equal(got[name], port["start"][name]), name
        else:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=name)


def test_bf16_steps_track_jax_and_keep_fp32_params():
    ref = _jax_run("bfloat16", 2)
    port = _port_run(ref, remat=True, dtype="bfloat16")
    np.testing.assert_allclose([m["loss"] for m in port["metrics"]],
                               [m["loss"] for m in ref["metrics"]], rtol=0, atol=2e-2)
    assert all(p.dtype == torch.float32 for p in port["model"].parameters())


def test_remat_policies_do_not_change_loss_or_grads(jax_fp32):
    """remat is a scheduling choice: no remat (stage-mask branch), remat
    "full" and remat "dots" give the same loss and gradients."""
    batch = _t(jax_fp32["batch"])
    results = {}
    for name, (remat, policy) in {"none": (False, "full"), "full": (True, "full"),
                                  "dots": (True, "dots")}.items():
        cfg = _slice_config(TConfig, remat=remat)
        cfg = dataclasses.replace(cfg, roberta=dataclasses.replace(cfg.roberta,
                                                                   remat_policy=policy))
        model = TModel(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jax_fp32["start"], cfg), strict=True)
        loss = model.train()(batch).loss
        named = [(n, p) for n, p in model.named_parameters()
                 if toptim.label_params([n])[n] != "frozen"]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        results[name] = (float(loss.detach()), {n: g for (n, _), g in zip(named, grads)})
    for name in ("full", "dots"):
        np.testing.assert_allclose(results[name][0], results["none"][0], rtol=1e-6)
        for key, g in results[name][1].items():
            np.testing.assert_allclose(g.numpy(), results["none"][1][key].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{name} {key}")


def test_configs_round_trip_with_jax():
    """TrainConfig has JAX's fields and defaults, and JSON loads both ways;
    the slice's model config is the JAX production geometry."""
    tcfg = TrainConfig(learning_rate=3e-4, mesh_shape=(2, 1), gradient_accumulation_steps=4)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    assert TrainConfig.from_json(tcfg.to_json()) == tcfg
    raw = json.loads(tcfg.to_json())
    assert JTrainConfig(**{**raw, "mesh_shape": tuple(raw["mesh_shape"])}) == JTrainConfig(
        learning_rate=3e-4, mesh_shape=(2, 1), gradient_accumulation_steps=4)
    cfg = pmr_training_config()
    jcfg = JConfig.from_json(cfg.to_json())
    assert jcfg.roberta.remat and jcfg.roberta.remat_policy == "full"
    assert jcfg.roberta.mem_efficient_attention and not jcfg.compute_alignment
    assert jcfg.roberta.dtype == jcfg.global_encoder.dtype == "bfloat16"
    assert jcfg.mapping_dropout == jcfg.roberta.attention_probs_dropout_prob == 0.0
    assert jcfg.global_encoder.hidden_size == 768 and jcfg.roberta.num_hidden_layers == 24
    assert TConfig.from_json(jcfg.to_json()) == cfg


def test_label_params_match_jax(jax_fp32):
    """Every label holds as many parameter elements as JAX's."""
    tree = jax_fp32["start"]
    names = dict(TModel(_slice_config(TConfig, True), device="cpu").named_parameters())
    for freeze_encoders, freeze_body in [(True, False), (True, True), (False, False)]:
        jl = joptim.label_params(tree, freeze_encoders=freeze_encoders,
                                 freeze_roberta_body=freeze_body)
        want: dict = {}
        for lab, leaf in zip(jax.tree.leaves(jl), jax.tree.leaves(tree)):
            want[lab] = want.get(lab, 0) + leaf.size
        tl = toptim.label_params(names, freeze_encoders=freeze_encoders,
                                 freeze_roberta_body=freeze_body)
        got: dict = {}
        for n, p in names.items():
            got[tl[n]] = got.get(tl[n], 0) + p.numel()
        assert got == want, (freeze_encoders, freeze_body)


@pytest.mark.parametrize("scheduler,warmup", [("linear", 0), ("linear", 3),
                                              ("constant", 0), ("constant", 3)])
def test_schedule_matches_optax(scheduler, warmup):
    cfg = dict(scheduler=scheduler, warmup_steps=warmup)
    want = joptim.make_schedule(JTrainConfig(**cfg), 12)
    got = toptim.make_schedule(TrainConfig(**cfg), 12)
    for n in range(15):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-7,
                                   err_msg=str(n))


def test_accumulation_and_adamw_match_optax_step_by_step():
    """k = 2 accumulation, clipping, warmup, the lr x 0.1 seq_enc group and
    masked weight decay, micro-step by micro-step."""
    rng = np.random.default_rng(0)
    shapes = {"global_enc/kernel": (3, 4), "seq_enc/kernel": (4, 2), "seq_enc/bias": (2,),
              "fusion/kernel": (4, 4), "fusion/bias": (4,),
              "roberta/layer_norm/scale": (4,)}
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}

    def nest(flat):
        tree: dict = {}
        for n, x in flat.items():
            node = tree
            *path, leaf = n.split("/")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = x
        return tree

    cfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2, scheduler="linear",
               gradient_accumulation_steps=2, freeze_encoders=False)
    jparams = jax.tree.map(jax.numpy.asarray, nest(init))
    tx = joptim.make_optimizer(JTrainConfig(**cfg), 20, jparams)
    jstate = tx.init(jparams)
    tparams = {n.replace("/", "."): torch.nn.Parameter(torch.from_numpy(x.copy()))
               for n, x in init.items()}
    labels = toptim.label_params(tparams, freeze_encoders=False)
    assert labels["seq_enc.kernel"] == "seq" and labels["fusion.bias"] == "main"
    opt = toptim.AdamW(tparams, labels, TrainConfig(**cfg), 20)
    state = TrainState(model=torch.nn.Module(), optimizer=opt,
                       accumulator=toptim.MaskedMultiSteps(opt.params, 2))
    for t in range(8):
        scale = 1.0 if t % 3 else 0.01      # some windows clip, some do not
        g = {n: (scale * rng.normal(size=s)).astype(np.float32) for n, s in shapes.items()}
        upd, jstate = tx.update(nest(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state.apply_gradients({n.replace("/", "."): torch.from_numpy(x) for n, x in g.items()})
        for n in shapes:
            want = np.asarray(_get(jparams, n))
            np.testing.assert_allclose(tparams[n.replace("/", ".")].detach().numpy(), want,
                                       rtol=1e-6, atol=1e-6, err_msg=f"step {t} {n}")
    assert state.step == 8 and opt.count == 4


def test_global_norm_matches_optax_on_large_tensors():
    """optax's global norm, also where a single fp32 leaf has 10M elements
    (where a sequential fp32 accumulation drifts by ~4e-4)."""
    rng = np.random.default_rng(1)
    leaves = [(1e-3 * rng.normal(size=n)).astype(np.float32) for n in (10_000_000, 7, 4096)]
    want = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in leaves))
    got = toptim.global_norm([torch.from_numpy(x) for x in leaves])
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(optax.global_norm([jax.numpy.asarray(x) for x in leaves])),
                               want, rtol=1e-5)


def _get(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def test_frozen_parameters_get_no_state_or_accumulator():
    model = TModel(_slice_config(TConfig, True), device="cpu")
    state = TrainState.create(model, TrainConfig(gradient_accumulation_steps=4), 10)
    assert state.accumulator is not None
    frozen = [n for n in dict(model.named_parameters()) if "_enc." in n]
    assert frozen and not any(n in state.optimizer.mu or n in state.accumulator.acc
                              for n in frozen)
    assert "roberta.encoder.layer.0.attention.self.query.weight" in state.accumulator.acc


class _Indices:
    """A dataset whose batch is its index list."""

    def __len__(self):
        return 10

    def batch(self, idx):
        return {"idx": np.asarray(idx)}


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_matches_jax(drop_last):
    kw = dict(batch_size=4, shuffle=True, seed=5, drop_last=drop_last, prefetch=False)
    jl, tl = JLoader(_Indices(), **kw), DataLoader(_Indices(), **kw)
    assert len(jl) == len(tl) == (2 if drop_last else 3)
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for a, b in zip(jl, tl, strict=True):
            np.testing.assert_array_equal(a["idx"], b["idx"])
            np.testing.assert_array_equal(a["example_mask"], b["example_mask"])
    last = list(DataLoader(_Indices(), batch_size=4))[-1]
    np.testing.assert_array_equal(last["example_mask"], [1, 1, 0, 0])
    np.testing.assert_array_equal(last["idx"], [8, 9, 8, 9])


PMR_ROWS = [
    {"total_id": 7, "img_id": "img-0", "objects": ["person", "dog"],
     "premise": ["the", [0], "walks", [0, 1], "."], "answer_label": 2,
     "answer_choices": [["yes", "."], ["no", [1], "."], ["maybe"], ["never", [5]]],
     "answer_types": [0, 1, 0, 0]},
    {"annot_id": "a1", "img_fn": "img-1", "objects": ["car"], "answer_label": [0, 3],
     "premise": [[0], "is", "red", "near", "the", "street"],
     "answer_choices": [["a", [0]], ["b"], ["c"], ["d"]]},
    {"img_id": "img-0", "premise": ["x"], "answer_choices": [["a"], ["b"], ["c"], ["d"]]},
]


def test_pmr_jsonl_loader_and_batches_match_jax(tmp_path):
    path = tmp_path / "val-ori.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in PMR_ROWS))
    want, got = jpmr.load_pmr_jsonl(str(path)), tpmr.load_pmr_jsonl(str(path))
    assert [dataclasses.asdict(x) for x in got] == [dataclasses.asdict(x) for x in want]
    assert [x.example_id for x in got] == ["7", "a1", "2"] and got[2].answer_label is None
    assert len(tpmr.load_pmr_jsonl(str(path), limit=2)) == 2

    cfg = JConfig.tiny()
    dim = cfg.global_encoder.img_feature_dim
    feats = np.random.default_rng(0).normal(size=(2, 5, dim)).astype(np.float32)
    spec = dict(text_len=40, img_len=cfg.img_len, roberta_len=80, img_feature_dim=dim)
    sides = []
    for pmr, col, sch, tok in ((jpmr, jcollate, jschemas, jtok), (tpmr, tcollate, tschemas, ttok)):
        images = {f"img-{i}": sch.ImageFeatures(features=feats[i], num_regions=5)
                  for i in range(2)}
        examples = pmr.load_pmr_jsonl(str(path), limit=2)
        sides.append(pmr.PMRDataset(
            examples, images, tok.HashTokenizer(vocab_size=cfg.global_encoder.vocab_size),
            tok.RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size),
            spec=col.BatchSpec(**spec), max_chunks=cfg.max_chunks, feat_cache_size=1))
    jb, tb = (ds.batch([0, 1, 0]) for ds in sides)   # a cache of one entry evicts
    assert set(jb) == set(tb)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_save_config_writes_loadable_json(tmp_path):
    tcfg = TrainConfig(learning_rate=2e-5, warmup_steps=3)
    save_config(str(tmp_path), "train_config.json", tcfg)
    save_config(str(tmp_path), "run.json", {"seed": 3, "path": tmp_path})
    assert TrainConfig.from_json((tmp_path / "train_config.json").read_text()) == tcfg
    assert json.loads((tmp_path / "run.json").read_text()) == {"seed": 3,
                                                               "path": str(tmp_path)}


@pytest.fixture(scope="module")
def tiny_data():
    """A tiny model and a labelled synthetic PMR dataset of 10 examples."""
    cfg = _slice_config(TConfig, remat=True)
    ds = synthetic_dataset(np.random.default_rng(0), 10, cfg)
    assert any(isinstance(ex.answer_label, list) for ex in ds.examples)
    sd = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    return cfg, ds, sd


def _model(tiny_data):
    cfg, _, sd = tiny_data
    model = TModel(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


def test_checkpoint_round_trip_and_params_only(tiny_data, tmp_path):
    cfg, ds, _ = tiny_data
    batch = {k: torch.from_numpy(v) for k, v in ds.batch([0, 1]).items()}
    tcfg = TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2)
    state = TrainState.create(_model(tiny_data), tcfg, 10)
    for _ in range(3):
        train_step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "full"))
    mgr.save(state, {"accuracy": 0.5})
    assert mgr.latest_step() == 3 == mgr.best_step()
    fresh = mgr.restore(TrainState.create(_model(tiny_data), tcfg, 10))
    assert fresh.step == 3 and fresh.optimizer.count == 1
    assert fresh.accumulator.mini_step == 1
    for name, t in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], t), name
    for name, t in state.optimizer.mu.items():
        assert torch.equal(fresh.optimizer.mu[name], t), name
    np.testing.assert_array_equal(eval_step(fresh.model, batch)["logits"].numpy(),
                                  eval_step(state.model, batch)["logits"].numpy())

    lean = CheckpointManager(str(tmp_path / "lean"), params_only=True)
    lean.save(state, {"accuracy": 0.5})
    assert set(torch.load(str(tmp_path / "lean" / "3" / "state.pt"))) == {"params", "step"}
    got = lean.restore_params(best=True)
    assert torch.equal(got["abst_confidence_scorer.weight"],
                       state.model.abst_confidence_scorer.weight.detach())
    with pytest.raises(ValueError, match="params-only"):
        lean.restore(TrainState.create(_model(tiny_data), tcfg, 10))


def test_checkpoints_keep_the_best_by_accuracy(tiny_data, tmp_path):
    state = TrainState.create(_model(tiny_data), TrainConfig(), 10)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, params_only=True)
    for step, acc in zip((1, 2, 3, 4), (0.1, 0.9, 0.5, 0.3)):
        state.step = step
        mgr.save(state, {"accuracy": acc})
    assert mgr.all_steps() == [2, 3, 4]
    assert mgr.best_step() == 2 and mgr.latest_step() == 4


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(tiny_data):
    _, ds, _ = tiny_data
    trainer = Trainer(_model(tiny_data), TrainConfig(), DataLoader(ds, 2), device="cpu")
    assert trainer.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(_model(tiny_data), TrainConfig(), DataLoader(ds, 2))


def test_trainer_fit_honours_max_steps_and_saves_best(tiny_data, tmp_path):
    _, ds, _ = tiny_data
    train = DataLoader(ds, 2, shuffle=True, seed=1)        # 5 batches per epoch
    val = DataLoader(ds, 4)                                 # padded last batch
    tcfg = TrainConfig(learning_rate=1e-3, max_steps=7, valid_steps=3, epoch_begin=1)
    trainer = Trainer(_model(tiny_data), tcfg, train, val,
                      checkpoint_dir=str(tmp_path), device="cpu")
    trainer.best_acc = -1.0                                 # the first validation saves
    state = trainer.fit()
    assert state.step == 7 and state.optimizer.count == 7
    assert [h["step"] for h in trainer.history] == [3, 6]
    assert trainer.ckpt.latest_step() in (3, 6)
    assert 0.0 <= trainer.evaluate() <= 1.0
