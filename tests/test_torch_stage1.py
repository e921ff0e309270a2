"""PyTorch port, ChunkAlign stage 1 and the two-stage recipe:
``models/chunkalign_cls.py``, ``interop/export.py``,
``interop/assemble.py::assemble_chunkalign_cls_params``,
``interop/from_jax.py::chunkalign_cls_params_from_jax`` and
``cli/train_two_stage.py``, held against the JAX package on the CPU in fp32
with the same numpy inputs and weights.

Tolerances: forwards, gradients and the 4-step trajectories within 2e-4
abs/rel (the port tests' bound, tests/test_torch_models.py); exports and
grafts key for key and bit for bit.  The classifier forward and one ModCR
logits test also run at the two odd geometries of JAX
``tests/test_odd_geometry.py`` (K = 2 with one image region, K = 5; odd
text and RoBERTa lengths).

The two-stage programs (JAX ``scripts/train_two_stage.py`` and the port's
``cli/train_two_stage.py``) are compared at ``--tiny`` on synthetic rows
(``serving/synthetic.py::task_rows``) with ``--no_device_features`` on the
JAX side.  Each side draws its own random init, so the test hands the port
the JAX script's initial parameters of both stages (recorded from the JAX
run) through the port command's model classes.  Stage 1 is deterministic at
``--tiny`` (every encoder dropout 0), so its curve, export and the graft
must match.  Stage 2 trains under ``mapping_dropout=0.1``, whose streams
cannot match, so the comparison stops at its post-surgery accuracy
(``--stage2_steps 0``); the port's stage-2 training is held to its curve's
shape and finiteness in the ``--stage1_task both`` run.
"""

import copy
import dataclasses
import json
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_context_reasoning_tpu.interop import assemble as jassemble
from multimodal_context_reasoning_tpu.interop.export import export_chunkalign_cls_state_dict
from multimodal_context_reasoning_tpu.models.chunkalign_cls import (
    ChunkAlignClassifier as JClassifier,
)
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.train import optim as joptim
from multimodal_context_reasoning_tpu.train import trainer as jtrainer
from multimodal_context_reasoning_tpu.train.state import TrainState as JState
from multimodal_context_reasoning_tpu.train.step import make_train_step
from multimodal_context_reasoning_torch.cli import train_two_stage as ttwo
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.interop import assemble as tassemble
from multimodal_context_reasoning_torch.interop import export as texport
from multimodal_context_reasoning_torch.interop.from_jax import (
    chunkalign_cls_params_from_jax,
    params_from_jax,
)
from multimodal_context_reasoning_torch.models.chunkalign_cls import ChunkAlignClassifier
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.synthetic import task_rows, write_rows
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import train_step
from tests.test_torch_models import make_batch

TOL = dict(rtol=2e-4, atol=2e-4)
GEOMS = {
    "tiny": {},
    "K2-img1-odd-lens": dict(num_labels=2, text_len=13, img_len=1, roberta_len=17,
                             prefix_len=2),
    "K5-img3-odd-lens": dict(num_labels=5, text_len=19, img_len=3, roberta_len=23,
                             prefix_len=3),
}
STEPS = 4
TCFG = dict(learning_rate=1e-3, scheduler="linear", warmup_steps=1, weight_decay=0.01,
            freeze_encoders=False, seq_enc_lr_scale=1.0)
TOTAL_STEPS = 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is tiny: one intra-op thread keeps it off the cores
    the other test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _cls_batch(cfg, seed=0):
    """A collate-shaped stage-1 batch: the composite's streams less RoBERTa's."""
    return {k: v for k, v in make_batch(cfg, seed=seed).items() if not k.startswith("r_")}


def _jax_params(jmodel, batch, port, graft, to_port):
    """JAX parameters holding the port model's seeded random weights: the
    JAX graft of the port's reference-layout state dict into a zero tree of
    the JAX init's shapes (tracing the init, which costs far less than
    compiling it).  Mapped back by ``to_port`` they are the port's weights
    exactly, so every leaf was grafted."""
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                          jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), _j(batch)))
    graft(params, {k: v.numpy() for k, v in port.state_dict().items()})
    for k, v in to_port(params).items():
        assert torch.equal(v, port.state_dict()[k]), k
    return params


def _setup(geom: str):
    jcfg = dataclasses.replace(JConfig.tiny(), **GEOMS[geom])
    tcfg = dataclasses.replace(TConfig.tiny(), **GEOMS[geom])
    kw = dict(num_labels=jcfg.num_labels, max_chunks=jcfg.max_chunks, align_weight=0.5)
    jmodel = JClassifier(jcfg.seq_encoder, jcfg.chunkalign, **kw)
    batch = _cls_batch(jcfg)
    tmodel = ChunkAlignClassifier(tcfg.seq_encoder, tcfg.chunkalign, **kw, device="cpu")
    enc = tcfg.seq_encoder
    params = _jax_params(
        jmodel, batch, tmodel,
        lambda p, sd: jassemble.assemble_chunkalign_cls_params(p, jcfg.seq_encoder, sd),
        lambda p: chunkalign_cls_params_from_jax(p, enc))
    return dict(jcfg=jcfg, tcfg=tcfg, j=jmodel, t=tmodel, params=params, batch=batch)


@pytest.fixture(scope="module")
def tiny():
    return _setup("tiny")


@pytest.mark.parametrize("geom", list(GEOMS))
def test_classifier_forward_matches_jax(geom, tiny):
    s = tiny if geom == "tiny" else _setup(geom)
    want = jax.jit(s["j"].apply)(s["params"], _j(s["batch"]))
    with torch.no_grad():
        got = s["t"].eval()(_t(s["batch"]))
    for name in ("loss", "cls_loss", "align_loss", "logits", "binary_logits"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   **TOL, err_msg=name)
    K = s["jcfg"].num_labels
    assert got.logits.shape == (len(s["batch"]["label"]) // K, K)
    # with one image region the alignment CE is over one class: 0
    assert (float(got.align_loss) > 0) == (s["jcfg"].img_len > 1) and float(got.cls_loss) > 0
    np.testing.assert_allclose(float(got.loss), float(got.cls_loss) + 0.5 * float(got.align_loss),
                               rtol=1e-6)


def test_classifier_gradients_match_jax(tiny):
    batch = _j(tiny["batch"])
    jgrads = jax.jit(jax.grad(lambda p: tiny["j"].apply(p, batch).loss))(tiny["params"])
    want = chunkalign_cls_params_from_jax(jax.tree.map(np.asarray, jgrads),
                                          tiny["tcfg"].seq_encoder)
    model = tiny["t"].train()
    named = list(model.named_parameters())
    out = model(_t(tiny["batch"]))
    grads = torch.autograd.grad(out.loss, [p for _, p in named], allow_unused=True)
    model.eval()
    touched = 0
    for (name, _), g in zip(named, grads):
        w = want[name].numpy()
        if g is None:
            # only the unused edge_dense table goes without a gradient
            assert name == "seq_enc.edge_dense.weight" and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
        touched += bool(np.abs(w).max() > 0)
    assert touched > 150


def _jax_trajectory(s):
    tx = joptim.make_optimizer(JTrainConfig(**TCFG), TOTAL_STEPS, s["params"])
    state = JState.create(s["params"], tx)
    step = make_train_step(s["j"], donate=False)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, _j(s["batch"]), jax.random.PRNGKey(100 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def test_stage1_trajectory_matches_jax(tiny):
    """Four steps of both towers training (``freeze_encoders=False``,
    ``seq_enc_lr_scale=1.0``, the two-stage command's stage 1): JAX
    ``make_train_step`` against the port's ``train_step``."""
    s = dict(tiny, t=copy.deepcopy(tiny["t"]))
    jmetrics, jend = _jax_trajectory(s)
    start = {k: v.clone() for k, v in s["t"].state_dict().items()}
    state = TrainState.create(s["t"], TrainConfig(**TCFG), TOTAL_STEPS)
    batch = _t(s["batch"])
    tmetrics = [{k: float(v) for k, v in train_step(state, batch).items()}
                for _ in range(STEPS)]
    for key in ("loss", "align_loss", "grad_norm", "correct", "count"):
        np.testing.assert_allclose([m[key] for m in tmetrics], [m[key] for m in jmetrics],
                                   **TOL, err_msg=key)
    assert [g["scale"] for g in state.optimizer.groups] == [1.0, 1.0]
    want = chunkalign_cls_params_from_jax(jend, s["tcfg"].seq_encoder)
    got = s["t"].state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **TOL, err_msg=name)
    for tower in ("global_enc.", "seq_enc."):
        assert any(not torch.equal(got[n], start[n]) for n in got if n.startswith(tower))


def test_export_equals_the_jax_export_and_grafts_back(tiny):
    """The port's export has the JAX export's keys, in its order, and its
    values; grafted into a fresh classifier it reproduces the source exactly,
    with the JAX graft's report."""
    enc = tiny["tcfg"].seq_encoder
    want = export_chunkalign_cls_state_dict(tiny["params"], tiny["jcfg"].seq_encoder)
    got = texport.export_chunkalign_cls_state_dict(tiny["t"], enc)
    assert list(got) == list(want) == texport.chunkalign_cls_keys(enc)
    assert set(got) == set(tiny["t"].state_dict())
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert texport.export_chunkalign_cls_state_dict(tiny["t"].state_dict(), enc).keys() == \
        got.keys()

    fresh = ChunkAlignClassifier(enc, tiny["tcfg"].chunkalign, max_chunks=8, device="cpu",
                                 generator=torch.Generator().manual_seed(9))
    params = dict(fresh.state_dict())
    report = tassemble.assemble_chunkalign_cls_params(params, enc, got, strict=True)
    fresh.load_state_dict(params, strict=True)
    jfresh = jax.tree.map(np.zeros_like, tiny["params"])
    jreport = jassemble.assemble_chunkalign_cls_params(jfresh, tiny["jcfg"].seq_encoder,
                                                       dict(want), strict=True)
    assert report.consumed == jreport.consumed == set(want)
    assert not report.skipped and not report.unconsumed
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_graft_skips_dead_keys_and_refuses_unknown_ones_as_jax(tiny):
    """ClsLayer2's dead attention is skipped with JAX's reason; a key that is
    neither grafted nor known-dead raises under ``strict`` on both sides and
    is reported otherwise."""
    enc, jenc = tiny["tcfg"].seq_encoder, tiny["jcfg"].seq_encoder
    sd = dict(export_chunkalign_cls_state_dict(tiny["params"], jenc))
    sd["cls_layer.1.attention.self.query.weight"] = np.ones((32, 32), np.float32)
    runs = {}
    for strict in (True, False):
        for extra in ({}, {"cls_layer.0.mystery.weight": np.ones((2,), np.float32)}):
            src = {**sd, **extra}
            params = dict(tiny["t"].state_dict())
            jparams = jax.tree.map(np.zeros_like, tiny["params"])
            if strict and extra:
                with pytest.raises(KeyError, match="mystery"):
                    tassemble.assemble_chunkalign_cls_params(params, enc, src)
                with pytest.raises(KeyError, match="mystery"):
                    jassemble.assemble_chunkalign_cls_params(jparams, jenc, dict(src))
                continue
            report = tassemble.assemble_chunkalign_cls_params(params, enc, src, strict=strict)
            jreport = jassemble.assemble_chunkalign_cls_params(jparams, jenc, dict(src),
                                                               strict=strict)
            assert report.summary() == jreport.summary()
            assert report.skipped == jreport.skipped
            assert report.unconsumed == jreport.unconsumed == set(extra)
            runs[(strict, bool(extra))] = report
    assert list(runs[(True, False)].skipped) == ["cls_layer.1.attention.self.query.weight"]


def test_stage1_export_feeds_the_stage2_surgery(tiny):
    """The stage-1 -> stage-2 handoff: the export drives
    ``assemble_modcr_params(chunkalign_sd=..., oscar_sd=...)`` (the
    ``seq_enc.`` strip and the global slot) with the JAX report, and the
    composite's towers take the stage-1 weights bit for bit."""
    enc = tiny["tcfg"].seq_encoder
    sd = texport.export_chunkalign_cls_state_dict(tiny["t"], enc)
    global_sd = {k[len("global_enc."):]: v for k, v in sd.items()
                 if k.startswith("global_enc.")}
    cfg = TConfig.tiny()
    model = TModel(cfg, device="cpu")
    params = dict(model.state_dict())
    report = tassemble.assemble_modcr_params(params, cfg, oscar_sd=global_sd, chunkalign_sd=sd)
    model.load_state_dict(params, strict=True)
    jcfg = JConfig.tiny()
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        JModel(jcfg).init, jax.random.PRNGKey(0), _j(make_batch(jcfg))))
    jreport = jassemble.assemble_modcr_params(jparams, jcfg, oscar_sd=dict(global_sd),
                                              chunkalign_sd=dict(sd))
    assert report.summary() == jreport.summary()
    assert report.consumed == jreport.consumed and not report.unconsumed
    state = model.state_dict()
    for k, v in sd.items():
        if k.startswith(("global_enc.", "seq_enc.")):
            np.testing.assert_array_equal(state["calec." + k].numpy(), v, err_msg=k)
    assert len(report.consumed) == sum(k.startswith(("global_enc.", "seq_enc.")) for k in sd)


@pytest.mark.parametrize("geom", [g for g in GEOMS if g != "tiny"])
def test_modcr_logits_match_jax_at_odd_geometries(geom):
    jcfg = dataclasses.replace(JConfig.tiny(), **GEOMS[geom])
    tcfg = dataclasses.replace(TConfig.tiny(), **GEOMS[geom])
    batch = make_batch(jcfg, seed=1)
    jmodel = JModel(jcfg)
    tmodel = TModel(tcfg, device="cpu")
    params = _jax_params(
        jmodel, batch, tmodel,
        lambda p, sd: jassemble.assemble_modcr_params(p, jcfg, modcr_sd=sd),
        lambda p: params_from_jax(p, tcfg))
    want = jax.jit(jmodel.apply)(params, _j(batch))
    with torch.no_grad():
        got = tmodel.eval()(_t(batch))
    assert got.logits.shape == (2, jcfg.num_labels)
    for field in ("logits", "loss", "align_loss"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **TOL, err_msg=field)


# ---------------------------------------------------------------- the two-stage programs

TWO_STAGE_FLAGS = ["--tiny", "--stage1_steps", "4", "--stage2_steps", "0", "--batch", "4",
                "--stage1_batch", "4", "--valid_steps", "2", "--warmup", "2",
                "--lr1", "1e-3"]


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """PMR and VCR rows written from a seed, with texts short enough for the
    tiny geometry's 16 BERT and 20 RoBERTa tokens."""
    d = tmp_path_factory.mktemp("two_stage_rows")
    rng = np.random.default_rng(0)
    paths = {"pmr": str(d / "pmr.jsonl"), "vcr": str(d / "vcr.json")}
    write_rows(paths["pmr"], task_rows(rng, 30, 8, words=(1, 4)))
    write_rows(paths["vcr"], task_rows(rng, 20, 8, vcr=True, first=500, words=(1, 4)))
    return paths


class _Recorder:
    """Records the JAX script's initial parameters of both stages and the
    reports of its grafts."""

    def __init__(self, mp):
        self.stage1 = self.stage2 = None
        self.reports = []
        init_state = jtrainer.Trainer.init_state

        def record_init(trainer):
            state = init_state(trainer)
            self.stage1 = jax.tree.map(np.asarray, state.params)
            return state

        assemble = jassemble.assemble_modcr_params

        def record_assemble(params, *args, **kw):
            self.stage2 = copy.deepcopy(params)
            report = assemble(params, *args, **kw)
            self.reports.append(report)
            return report

        mp.setattr(jtrainer.Trainer, "init_state", record_init)
        mp.setattr(jassemble, "assemble_modcr_params", record_assemble)


def _port_command(mp, argv, start=None):
    """Run the port command on the CPU; with ``start`` (a :class:`_Recorder`)
    both stages begin from the JAX script's initial parameters.  Returns the
    curve and the graft reports."""
    reports = []
    assemble = ttwo.assemble_modcr_params

    def record_assemble(*args, **kw):
        reports.append(assemble(*args, **kw))
        return reports[-1]

    mp.setattr(ttwo, "assemble_modcr_params", record_assemble)
    if start is not None:
        def classifier(enc, *args, **kw):
            model = ChunkAlignClassifier(enc, *args, **kw)
            model.load_state_dict(chunkalign_cls_params_from_jax(start.stage1, enc))
            return model

        def composite(cfg, **kw):
            model = TModel(cfg, **kw)
            model.load_state_dict(params_from_jax(start.stage2, cfg))
            return model

        mp.setattr(ttwo, "ChunkAlignClassifier", classifier)
        mp.setattr(ttwo, "ModCRModel", composite)
    curve = ttwo.main(argv + ["--device", "cpu"])
    return curve, reports


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_two_stage_command_matches_the_jax_script(rows, tmp_path):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    from scripts.train_two_stage import main as jmain

    argv = TWO_STAGE_FLAGS + ["--jsonl", rows["pmr"]]
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        want = jmain(argv + ["--no_device_features", "--out", str(tmp_path / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        got, reports = _port_command(mp, argv + ["--out", str(tmp_path / "port")], start=rec)
    logging.getLogger().handlers.clear()

    assert set(got) == set(want) and set(got["stage1"]) == set(want["stage1"])
    for key in ("task", "data", "n_train", "n_val", "batch", "stage1_batch", "tiny"):
        assert got[key] == want[key], key
    for key in ("baseline_acc", "best_acc", "final_acc"):
        assert got["stage1"][key] == pytest.approx(want["stage1"][key], abs=1e-6), key
    assert len(got["stage1"]["history"]) == len(want["stage1"]["history"]) == 2
    for g, w in zip(got["stage1"]["history"], want["stage1"]["history"]):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        assert g["val_acc"] == pytest.approx(w["val_acc"], abs=1e-6)
        for key in ("train_loss", "train_acc"):
            np.testing.assert_allclose(g[key], w[key], **TOL, err_msg=key)

    sd, jsd = _npz(tmp_path / "port" / "chunkalign_cls_state_dict.npz"), _npz(
        tmp_path / "jax" / "chunkalign_cls_state_dict.npz")
    assert list(sd) == list(jsd)
    for k, v in jsd.items():
        np.testing.assert_allclose(sd[k], v, **TOL, err_msg=k)
    assert len(reports) == len(rec.reports) == 1
    assert reports[0].summary() == rec.reports[0].summary()
    assert reports[0].consumed == rec.reports[0].consumed and not reports[0].unconsumed

    assert got["stage2"]["post_surgery_acc"] == pytest.approx(
        want["stage2"]["post_surgery_acc"], abs=1e-6)
    assert got["stage2"]["final_acc"] == got["stage2"]["post_surgery_acc"]
    assert [h["step"] for h in got["stage2"]["history"]] == [
        h["step"] for h in want["stage2"]["history"]] == [0]
    assert json.loads((tmp_path / "port" / "curve.json").read_text()) == got
    assert (tmp_path / "port" / "bert_vocab.txt").read_text() == (
        tmp_path / "jax" / "bert_vocab.txt").read_text()


def test_mixed_stage1_then_npz_reuse(rows, tmp_path):
    """``--stage1_task both`` pretrains on the PMR and VCR splits through
    ``MixedDataset``; ``--stage1_npz`` then grafts that export without
    retraining and, on the same stage-2 data and seed, reproduces its
    post-surgery accuracy."""
    common = ["--tiny", "--batch", "4", "--valid_steps", "2", "--warmup", "2",
              "--jsonl", rows["pmr"], "--tokenizer", "hash"]
    with pytest.MonkeyPatch.context() as mp:
        mixed, reports = _port_command(mp, common + [
            "--stage1_steps", "3", "--stage2_steps", "2", "--stage1_batch", "4",
            "--stage1_task", "both", "--stage1_jsonl", f"pmr:{rows['pmr']},vcr:{rows['vcr']}",
            "--stage1_valid_steps", "3", "--out", str(tmp_path / "mixed")])
    assert mixed["stage1"]["task"] == "both"
    assert mixed["stage1"]["data"] == "pmr.jsonl,vcr.json"
    assert [h["step"] for h in mixed["stage1"]["history"]] == [3]
    hist = mixed["stage2"]["history"]
    assert [h["step"] for h in hist] == [0, 2]
    assert hist[0]["val_acc"] == mixed["stage2"]["post_surgery_acc"]
    assert all(np.isfinite(h["train_loss"]) and 0 <= h["val_acc"] <= 1 for h in hist[1:])
    assert not reports[0].unconsumed and len(reports[0].consumed) > 0
    npz = tmp_path / "mixed" / "chunkalign_cls_state_dict.npz"
    enc = TConfig.tiny().seq_encoder
    assert list(_npz(npz)) == texport.chunkalign_cls_keys(enc)

    with pytest.MonkeyPatch.context() as mp:
        reuse, reuse_reports = _port_command(mp, common + [
            "--stage1_steps", "0", "--stage2_steps", "2", "--stage1_npz", str(npz),
            "--out", str(tmp_path / "reuse")])
    logging.getLogger().handlers.clear()
    assert reuse["stage1"] == {"npz": str(npz), "keys": len(texport.chunkalign_cls_keys(enc))}
    assert reuse_reports[0].summary() == reports[0].summary()
    assert reuse["stage2"]["post_surgery_acc"] == mixed["stage2"]["post_surgery_acc"]


def test_two_stage_command_refusals(rows, tmp_path):
    with pytest.raises(ValueError, match="pmr:/vcr:"):
        ttwo.main(["--device", "cpu", "--tiny", "--tokenizer", "hash", "--jsonl", rows["pmr"],
                   "--stage1_task", "both", "--out", str(tmp_path)])
    logging.getLogger().handlers.clear()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttwo.main(["--tiny"])
