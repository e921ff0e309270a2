"""PyTorch port, the one-stage real-data recipe: ``cli/train_real_pmr.py``
held against the JAX package's ``scripts/train_real_pmr.py`` on the CPU,
on rows written from a seed (``serving/synthetic.py::task_rows``), the JAX
side with ``--no_device_features``.

Each side draws its own random init, so the port command is handed the JAX
run's initial parameters (recorded from JAX ``Trainer.init_state``,
injected through the port command's ``ModCRModel`` name).  Compiling the
JAX init at ``--midsize`` takes about 25 s on a CPU, tracing it well
under one: the JAX run's init traces the shapes and grafts a seeded port
model's weights in (``assemble_modcr_params(modcr_sd=...)``, strict), and
every leaf is checked to have been grafted.  The trajectory
is held at ``--midsize --dropout 0``, which sets every dropout site to 0
(``mapping_dropout`` too; ``--tiny`` keeps its 0.1, whose streams differ):
accuracies within 1e-6, each validation's train loss and accuracy within
2e-4, the corpus vocabularies byte-equal.  ``--tiny --tokenizer hash`` is
held at its random-init accuracy and its curve's keys, ``--task vcr`` at
its featurized batches.
"""

import json
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_torch.cli import train_real_pmr as treal
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.synthetic import task_rows, write_rows
from multimodal_context_reasoning_tpu.interop import assemble as jassemble
from multimodal_context_reasoning_tpu.train import trainer as jtrainer
from multimodal_context_reasoning_tpu.train.optim import make_optimizer
from multimodal_context_reasoning_tpu.train.state import TrainState as JState
from multimodal_context_reasoning_tpu.train.step import _model_inputs

TOL = dict(rtol=2e-4, atol=2e-4)
MIDSIZE = ["--midsize", "--dropout", "0", "--tokenizer", "corpus", "--weight_decay", "0.01",
           "--steps", "4", "--batch", "4", "--eval_batch", "8", "--valid_steps", "2",
           "--warmup", "1", "--lr", "1e-3"]
TINY = ["--tiny", "--tokenizer", "hash", "--steps", "2", "--batch", "4", "--valid_steps", "2",
        "--warmup", "1"]
CURVE_KEYS = {"task", "data", "n_train", "n_val", "steps", "batch", "lr", "seed", "tiny",
              "wall_seconds", "baseline_acc", "final_acc", "best_acc", "history"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps the port's side off the cores the other
    test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("real_pmr_rows")
    rng = np.random.default_rng(0)
    paths = {"pmr": str(d / "pmr.jsonl"), "short": str(d / "short.jsonl"),
             "vcr": str(d / "vcr.json")}
    write_rows(paths["pmr"], task_rows(rng, 30, 8, words=(3, 9)))
    # the tiny geometry keeps 16 BERT and 20 RoBERTa tokens: longer texts
    # leave the 4 candidates identical (tied logits)
    write_rows(paths["short"], task_rows(rng, 30, 8, first=200, words=(1, 4)))
    write_rows(paths["vcr"], task_rows(rng, 20, 8, vcr=True, first=500, words=(1, 4)))
    return paths


def _jax_main():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from scripts.train_real_pmr import main

    return main


def _jax_run(mp, argv):
    """The JAX script on ``argv``; returns its trainer and initial params,
    a seeded port model's weights in the shapes the JAX init traces."""
    cfg = treal.model_config(treal.build_arg_parser().parse_args(argv))
    port = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    port_sd = {k: v.numpy() for k, v in port.state_dict().items()}
    start = {}

    def init_state(trainer, rng=None, sample_batch=None):
        inputs = _model_inputs({k: jnp.asarray(v)
                                for k, v in next(iter(trainer.train_loader)).items()})
        params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
            trainer.model.init, jax.random.PRNGKey(0), inputs))
        jassemble.assemble_modcr_params(params, trainer.model.config, modcr_sd=dict(port_sd))
        for k, v in params_from_jax(params, cfg).items():
            np.testing.assert_array_equal(v.numpy(), port_sd[k], err_msg=k)
        start["params"] = params
        tx = make_optimizer(trainer.cfg, trainer.t_total, params,
                            freeze_roberta_body=trainer.freeze_roberta_body)
        return JState.create(params, tx)

    mp.setattr(jtrainer.Trainer, "init_state", init_state)
    return _jax_main()(argv + ["--no_device_features"]), start["params"]


def _port_run(mp, argv, params=None):
    """The port command on the CPU, from ``params`` (a JAX tree) if given."""
    if params is not None:
        def model(cfg, **kw):
            m = TModel(cfg, **kw)
            m.load_state_dict(params_from_jax(params, cfg))
            return m

        mp.setattr(treal, "ModCRModel", model)
    return treal.main(argv + ["--device", "cpu"])


def _curve(out):
    return json.loads((Path(out) / "curve.json").read_text())


@pytest.fixture(scope="module")
def midsize(rows, tmp_path_factory):
    """The JAX script and the port (table on and off) at ``MIDSIZE``."""
    d = tmp_path_factory.mktemp("midsize")
    argv = MIDSIZE + ["--jsonl", rows["pmr"]]
    with pytest.MonkeyPatch.context() as mp:
        _, params = _jax_run(mp, argv + ["--out", str(d / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        _port_run(mp, argv + ["--out", str(d / "port")], params)
    with pytest.MonkeyPatch.context() as mp:
        _port_run(mp, argv + ["--out", str(d / "host"), "--no_device_features"], params)
    logging.getLogger().handlers.clear()
    return d


def test_midsize_trajectory_matches_the_jax_script(midsize):
    got, want = _curve(midsize / "port"), _curve(midsize / "jax")
    assert set(got) == set(want) == CURVE_KEYS
    for key in ("task", "data", "n_train", "n_val", "steps", "batch", "lr", "seed", "tiny"):
        assert got[key] == want[key], key
    for key in ("baseline_acc", "best_acc", "final_acc"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]] == [
        0, 2, 4]
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"]
        assert g["val_acc"] == pytest.approx(w["val_acc"], abs=1e-6)
        for key in ("train_loss", "train_acc"):
            if w[key] is None:
                assert g[key] is None, key
            else:
                np.testing.assert_allclose(g[key], w[key], **TOL, err_msg=key)
    for name in ("bert_vocab.txt", "roberta_vocab.txt"):
        assert (midsize / "port" / name).read_bytes() == (midsize / "jax" / name).read_bytes()


def test_device_table_leaves_the_history_as_it_was(midsize):
    """The resident table changes where the features live, not the numbers."""
    table, host = _curve(midsize / "port"), _curve(midsize / "host")
    assert table["history"] == host["history"]
    assert (table["baseline_acc"], table["final_acc"]) == (host["baseline_acc"],
                                                          host["final_acc"])


def test_tiny_hash_baseline_matches_the_jax_script(rows, tmp_path):
    argv = TINY + ["--jsonl", rows["short"]]
    with pytest.MonkeyPatch.context() as mp:
        _, params = _jax_run(mp, argv + ["--out", str(tmp_path / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        trainer = _port_run(mp, argv + ["--out", str(tmp_path / "port")], params)
    logging.getLogger().handlers.clear()
    got, want = _curve(tmp_path / "port"), _curve(tmp_path / "jax")
    assert set(got) == set(want) == CURVE_KEYS
    assert got["baseline_acc"] == pytest.approx(want["baseline_acc"], abs=1e-6)
    assert got["history"][0] == want["history"][0]
    assert [h["step"] for h in got["history"]] == [0, 2]
    assert trainer.history == got["history"]
    assert not (tmp_path / "port" / "bert_vocab.txt").exists()


def test_vcr_batches_match_the_jax_script(rows, tmp_path):
    argv = TINY + ["--task", "vcr", "--tokenizer", "corpus", "--jsonl", rows["vcr"]]
    with pytest.MonkeyPatch.context() as mp:
        jt, params = _jax_run(mp, argv + ["--out", str(tmp_path / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        tt = _port_run(mp, argv + ["--out", str(tmp_path / "port"), "--no_device_features"],
                       params)
    logging.getLogger().handlers.clear()
    assert _curve(tmp_path / "port")["baseline_acc"] == pytest.approx(
        _curve(tmp_path / "jax")["baseline_acc"], abs=1e-6)
    for loader in ("train_loader", "val_loader"):
        jl, tl = getattr(jt, loader), getattr(tt, loader)
        jl.set_epoch(0)
        tl.set_epoch(0)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) > 0, loader
        for j, t in zip(jb, tb):
            assert set(j) == set(t), loader
            for k in j:
                np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                              err_msg=f"{loader} {k}")


def test_too_few_train_examples_stop_the_run_as_in_jax(rows, tmp_path):
    """24 train examples fill no batch of 32: the JAX script's init draws a
    sample batch from the empty loader and stops; the port stops there too
    and, unlike the two-stage recipe, clamps nothing."""
    argv = TINY + ["--batch", "32", "--jsonl", rows["pmr"]]
    with pytest.raises(StopIteration):
        _jax_main()(argv + ["--no_device_features", "--out", str(tmp_path / "jax")])
    with pytest.raises(ValueError, match="24 train examples fill no batch of --batch 32"):
        treal.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    logging.getLogger().handlers.clear()


def test_command_runs_on_the_card_unless_asked(rows, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        treal.main(TINY + ["--jsonl", rows["pmr"], "--out", str(tmp_path)])
