"""PyTorch port, the two commands: ``cli/run_pmr.py`` and ``cli/run_vcr.py``
held against the JAX package's CLIs at ``--tiny --compute_dtype float32``,
batch 2, on the CPU.

The test writes its own data (PMR JSONL, a VCR JSON, a region-feature
pickle and an ``.mcrpack``) and one reference-layout ``{'net': ...}``
``.pth`` exported from JAX tiny parameters by
``interop/export.py::export_modcr_state_dict``.  Both CLIs start from it
through ``--modcr_ckpt``; the JAX CLI runs on one device (``--mesh_data 1
--mesh_model 1``: the test configuration gives JAX 8 virtual CPU devices).

``--tiny`` keeps the mapping networks' dropout at 0.1 (every other dropout
of the tiny config is 0), and JAX and torch draw dropout masks from
different streams.  So both CLIs' ``ModCRConfig.tiny`` are patched to set it
to 0 here, which makes training deterministic on both sides; evaluation
runs no dropout either way.  Losses, parameters and logits agree to fp32
tolerance: logits 1e-5 abs, losses and parameters 1e-4 relative (2e-5
abs for values near 0), as tests/test_torch_train.py holds its
trajectories.
"""

import dataclasses
import json
import os
import pickle
import types

import jax
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.cli import common as jcommon
from multimodal_context_reasoning_tpu.cli import run_pmr as jrun_pmr
from multimodal_context_reasoning_tpu.cli import run_vcr as jrun_vcr
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import vcr as jvcr
from multimodal_context_reasoning_tpu.data.tokenization import HashTokenizer as JHash
from multimodal_context_reasoning_tpu.data.tokenization import (
    RobertaHashTokenizer as JRobHash,
)
from multimodal_context_reasoning_tpu.interop import assemble as jassemble
from multimodal_context_reasoning_tpu.interop.export import export_modcr_state_dict
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.train import trainer as jtrainer
from multimodal_context_reasoning_torch.cli import common as tcommon
from multimodal_context_reasoning_torch.cli import run_pmr as trun_pmr
from multimodal_context_reasoning_torch.cli import run_vcr as trun_vcr
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.data import vcr as tvcr
from multimodal_context_reasoning_torch.data.feature_store import write_pack
from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer as THash
from multimodal_context_reasoning_torch.data.tokenization import (
    RobertaHashTokenizer as TRobHash,
)
from multimodal_context_reasoning_torch.interop import assemble as tassemble
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.synthetic import (
    region_features,
    task_rows,
    write_rows,
)
from multimodal_context_reasoning_torch.train import trainer as ttrainer
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager, save_config
from tests.test_torch_models import make_batch

LOGITS = dict(rtol=0, atol=1e-5)
TRAJ = dict(rtol=1e-4, atol=2e-5)
TRAIN_FLAGS = ["--do_train", "--max_steps", "4", "--learning_rate", "1e-3",
               "--warmup_steps", "1", "--valid_steps", "2", "--epoch_begin", "0"]


@pytest.fixture(scope="module", autouse=True)
def tiny_without_mapping_dropout():
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JConfig, TConfig):
            mp.setattr(cls, "tiny", classmethod(
                lambda c, tiny=cls.tiny: dataclasses.replace(tiny(), mapping_dropout=0.0)))
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Files both CLIs read: PMR train/val/test, a VCR JSON, features as a
    pickle and an .mcrpack, and the reference .pth of JAX tiny params."""
    d = tmp_path_factory.mktemp("cli_data")
    cfg = JConfig.tiny()
    rng = np.random.default_rng(0)
    # short texts: the tiny geometry keeps 16 BERT and 20 RoBERTa tokens
    rows = {name: task_rows(rng, n, cfg.img_len, first=first, words=(1, 4))
            for name, n, first in (("train", 8, 0), ("val", 8, 100), ("test", 6, 200))}
    rows["vcr"] = task_rows(rng, 8, cfg.img_len, vcr=True, first=300, words=(1, 4))
    paths = {}
    for name, r in rows.items():
        paths[name] = str(d / f"{name}.{'json' if name == 'vcr' else 'jsonl'}")
        write_rows(paths[name], r)
    feats = region_features(rng, sum(rows.values(), []), cfg.img_len,
                            cfg.global_encoder.img_feature_dim)
    paths["pkl"] = str(d / "feats.pkl")
    with open(paths["pkl"], "wb") as f:
        pickle.dump({k: {"features": v} for k, v in feats.items()}, f)
    paths["pack"] = str(d / "feats.mcrpack")
    write_pack(feats, paths["pack"])

    params = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(7), make_batch(cfg))
    params = jax.tree.map(np.asarray, params)
    export = export_modcr_state_dict(params, cfg)
    paths["pth"] = str(d / "best.pth")
    torch.save({"net": {k: torch.from_numpy(np.array(v)) for k, v in export.items()}},
               paths["pth"])
    return dict(paths=paths, params=params, export=export, cfg=cfg, dir=d)


def _argv(data, out, *extra, feats="pkl"):
    p = data["paths"]
    return ["--tiny", "--compute_dtype", "float32", "--per_gpu_train_batch_size", "2",
            "--per_gpu_eval_batch_size", "4", "--img_feat_file", p[feats],
            "--modcr_ckpt", p["pth"], "--output_dir", str(data["dir"] / out), *extra]


def _jax_argv(data, out, *extra, **kw):
    return _argv(data, out, "--mesh_data", "1", "--mesh_model", "1", *extra, **kw)


def _port_argv(data, out, *extra, **kw):
    return _argv(data, out, "--device", "cpu", *extra, **kw)


def _predictions(data, out, task="pmr"):
    with open(data["dir"] / out / f"result_test_ModICR_{task}.json") as f:
        return [json.loads(line) for line in f]


def _run_test(module, main, argv):
    """--do_test through ``main``, capturing the logits it writes."""
    seen = []
    orig = module.write_test_predictions

    def spy(path, examples, logits):
        seen.append(np.asarray(logits))
        orig(path, examples, logits)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "write_test_predictions", spy)
        acc = main(argv)
    return acc, seen[0]


def _run_jax_train(main, argv):
    """--do_train through the JAX CLI, capturing each micro-step's loss."""
    losses = []
    make = jtrainer.make_train_step

    def counted(model, **kw):
        step = make(model, **kw)

        def run(state, batch, rng):
            state, metrics = step(state, batch, rng)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "make_train_step", counted)
        # run_vcr rebinds these module globals of the JAX run_pmr
        mp.setattr(jrun_pmr, "DATASET_CLS", jrun_pmr.DATASET_CLS)
        mp.setattr(jrun_pmr, "LOAD_FN", jrun_pmr.LOAD_FN)
        state = main(argv)
    return dict(losses=losses, params=jax.tree.map(np.asarray, state.params))


def _run_port_train(main, argv):
    losses = []
    step = ttrainer.train_step

    def counted(state, batch):
        metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return metrics

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "train_step", counted)
        state = main(argv)
    return dict(losses=losses, state=state)


def test_import_overwrites_every_parameter(data):
    """The .pth sets every parameter of the port's tiny model to the JAX
    parameters it was exported from, so both CLIs start from one set of
    weights; the JAX graft consumes every key of it as well."""
    cfg = TConfig.tiny()
    params = dict(TModel(cfg, device="cpu").state_dict())
    report = tassemble.assemble_from_files(params, cfg, modcr_path=data["paths"]["pth"])
    assert set(params) <= report.consumed and not report.unconsumed
    want = params_from_jax(data["params"], cfg)
    assert set(want) == set(params)
    for name, value in want.items():
        assert torch.equal(params[name], value), name
    jparams = jax.tree.map(np.asarray, data["params"])
    jreport = jassemble.assemble_from_files(jparams, data["cfg"],
                                            modcr_path=data["paths"]["pth"])
    assert jreport.consumed == report.consumed == set(data["export"])


@pytest.fixture(scope="module")
def test_runs(data):
    p = data["paths"]
    test = ["--do_test", "--test_file", p["test"]]
    return dict(
        jax=_run_test(jrun_pmr, jrun_pmr.main, _jax_argv(data, "jax_test", *test)),
        port=_run_test(trun_pmr, trun_pmr.main, _port_argv(data, "port_test", *test)),
        pack=_run_test(trun_pmr, trun_pmr.main,
                       _port_argv(data, "port_test_pack", *test, feats="pack")),
    )


@pytest.mark.parametrize("run", ["port", "pack"], ids=["pickle", "mcrpack"])
def test_do_test_writes_the_jax_predictions(data, test_runs, run):
    (j_acc, j_logits), (t_acc, t_logits) = test_runs["jax"], test_runs[run]
    assert t_logits.shape == j_logits.shape == (6, 4)
    np.testing.assert_allclose(t_logits, j_logits, **LOGITS)
    assert t_acc == j_acc
    out = "port_test" if run == "port" else "port_test_pack"
    assert _predictions(data, out) == _predictions(data, "jax_test")
    assert (np.ptp(t_logits, axis=1) > 1e-4).all()   # no candidates tied


@pytest.fixture(scope="module")
def train_runs(data):
    p = data["paths"]
    train = [*TRAIN_FLAGS, "--train_file", p["train"], "--val_file", p["val"]]
    return dict(
        jax=_run_jax_train(jrun_pmr.main, _jax_argv(data, "jax_train", *train)),
        port=_run_port_train(trun_pmr.main, _port_argv(data, "port_train", *train)),
    )


def _check_trajectory(j, t, cfg, micro_steps):
    assert len(t["losses"]) == len(j["losses"]) == micro_steps
    np.testing.assert_allclose(t["losses"], j["losses"], **TRAJ)
    got = t["state"].model.state_dict()
    for name, want in params_from_jax(j["params"], cfg).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), **TRAJ, err_msg=name)


def test_do_train_matches_the_jax_trajectory(data, train_runs):
    cfg = TConfig.tiny()
    _check_trajectory(train_runs["jax"], train_runs["port"], cfg, micro_steps=4)
    start = params_from_jax(data["params"], cfg)
    got = train_runs["port"]["state"].model.state_dict()
    assert not torch.equal(got["roberta.encoder.layer.0.attention.self.query.weight"],
                           start["roberta.encoder.layer.0.attention.self.query.weight"])
    assert torch.equal(got["calec.global_enc.encoder.layer.0.output.dense.weight"],
                       start["calec.global_enc.encoder.layer.0.output.dense.weight"])


def test_do_train_writes_config_and_best_checkpoint_for_do_test(data, train_runs):
    """config.json and the best-accuracy checkpoint of --do_train feed
    --do_test --eval_model_dir, which writes one prediction per example."""
    out = data["dir"] / "port_train"
    saved = TConfig.from_json((out / "config.json").read_text())
    assert saved == TConfig.tiny()
    assert os.listdir(out / "ckpt")
    acc = trun_pmr.main(_port_argv(data, "port_eval", "--do_test", "--test_file",
                                   data["paths"]["test"], "--eval_model_dir", str(out)))
    preds = _predictions(data, "port_eval")
    assert 0.0 <= acc <= 1.0 and len(preds) == 6
    assert set(preds[0]) == {"total_id", "img_id", "prediction", "answer_type"}


@pytest.fixture(scope="module")
def vcr_runs(data):
    train = [*TRAIN_FLAGS, "--train_file", data["paths"]["vcr"]]
    return dict(
        jax=_run_jax_train(jrun_vcr.main, _jax_argv(data, "jax_vcr", *train)),
        port=_run_port_train(trun_vcr.main, _port_argv(data, "port_vcr", *train)),
    )


def test_run_vcr_matches_jax_with_the_roberta_body_frozen(data, vcr_runs):
    cfg = TConfig.tiny()
    # 4 optimizer steps of 4 accumulated micro-batches (run_vcr's default)
    _check_trajectory(vcr_runs["jax"], vcr_runs["port"], cfg, micro_steps=16)
    start = params_from_jax(data["params"], cfg)
    got = vcr_runs["port"]["state"].model.state_dict()
    body = [n for n in got if n.startswith("roberta.encoder.")]
    assert body and all(torch.equal(got[n], start[n]) for n in body)
    for name in ("roberta.embeddings.word_embeddings.weight",
                 "mapping_network_vision.1.weight", "mapping_network_alignment.4.weight"):
        assert not torch.equal(got[name], start[name]), name


def test_vcr_batches_are_bit_equal_to_jax(data):
    cfg, path, pkl = data["cfg"], data["paths"]["vcr"], data["paths"]["pkl"]
    jds = jvcr.VCRDataset(jvcr.load_vcr_json(path), jcommon.load_image_features(pkl, 20),
                          JHash(256), JRobHash(256), spec=jcommon.batch_spec(cfg),
                          max_chunks=cfg.max_chunks)
    tds = tvcr.VCRDataset(tvcr.load_vcr_json(path), tcommon.load_image_features(pkl, 20),
                          THash(256), TRobHash(256), spec=tcommon.batch_spec(TConfig.tiny()),
                          max_chunks=cfg.max_chunks)
    assert len(tds) == len(jds) == 8
    assert ([dataclasses.asdict(e) for e in tds.examples]
            == [dataclasses.asdict(e) for e in jds.examples])
    idx = list(range(len(jds)))
    jb, tb = jds.batch(idx), tds.batch(idx)
    assert set(jb) == set(tb)
    for key in jb:
        assert jb[key].dtype == tb[key].dtype and np.array_equal(jb[key], tb[key]), key


def _split_sources(export, vocab_cut=10):
    """An Oscar dict (``bert.`` keys, fewer word rows, a position-id
    buffer), a ChunkAlign dict (``seq_enc.`` keys beside a key outside that
    prefix) and a roberta-large dict (1-row token-type table, fewer word
    rows), cut from the composite export."""
    def tower(prefix, new_prefix):
        return {new_prefix + k[len(prefix):]: v for k, v in export.items()
                if k.startswith(prefix)}

    oscar = tower("calec.global_enc.", "bert.")
    oscar["bert.embeddings.word_embeddings.weight"] = (
        oscar["bert.embeddings.word_embeddings.weight"][:-vocab_cut])
    oscar["bert.embeddings.position_ids"] = np.arange(8)[None]
    chunk = tower("calec.seq_enc.", "seq_enc.")
    chunk["cls_layer.0.dense.weight"] = np.ones((2, 2), np.float32)
    rob = tower("roberta.", "roberta.")
    rob["roberta.embeddings.word_embeddings.weight"] = (
        rob["roberta.embeddings.word_embeddings.weight"][:-vocab_cut])
    rob["roberta.embeddings.token_type_embeddings.weight"] = (
        rob["roberta.embeddings.token_type_embeddings.weight"][:1])
    composite = dict(export)
    rng = np.random.default_rng(3)
    for dead in ("classifier.weight", "calec.cls_layer_lyx.0.ensemble.weight",
                 "promptfuse.weight"):
        composite[dead] = rng.standard_normal((2, 3)).astype(np.float32)
    return dict(oscar=oscar, chunkalign=chunk, roberta=rob, modcr=composite)


@pytest.fixture(scope="module")
def split_files(data):
    out = {}
    for name, sd in _split_sources(data["export"]).items():
        out[name] = str(data["dir"] / f"{name}.pth")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out[name])
    return out


@pytest.fixture(scope="module")
def fresh_params(data):
    """JAX tiny parameters of another init than the exported ones."""
    return jax.tree.map(np.asarray, jax.jit(JModel(data["cfg"]).init)(
        jax.random.PRNGKey(11), make_batch(data["cfg"])))


@pytest.mark.parametrize("sources,cold_start", [
    (("oscar", "chunkalign", "roberta"), False), (("modcr",), False), (("modcr",), True),
    (("oscar", "chunkalign", "roberta", "modcr"), True),
], ids=["split", "composite", "composite_cold_start", "all_cold_start"])
def test_assemble_from_files_matches_jax(data, split_files, fresh_params, sources, cold_start):
    """Both ``assemble_from_files`` on the same sources, from the same fresh
    parameters (a JAX init carried across): equal parameters, and reports
    with the same consumed, skipped and unconsumed keys."""
    jcfg, tcfg = data["cfg"], TConfig.tiny()
    fresh = jax.tree.map(np.array, fresh_params)
    tparams = {k: v.clone() for k, v in params_from_jax(fresh, tcfg).items()}
    paths = {f"{name}_path": split_files[name] for name in sources}
    jreport = jassemble.assemble_from_files(fresh, jcfg, cold_start=cold_start, **paths)
    treport = tassemble.assemble_from_files(tparams, tcfg, cold_start=cold_start, **paths)
    assert treport.consumed == jreport.consumed
    assert treport.skipped == jreport.skipped
    assert treport.unconsumed == jreport.unconsumed == set()
    assert treport.summary() == jreport.summary()
    want = params_from_jax(fresh, tcfg)
    assert set(tparams) == set(want)
    for name, value in want.items():
        assert torch.equal(tparams[name], value), name


def test_split_sources_and_cold_start_through_the_cli(data, split_files, monkeypatch):
    """``--oscar_ckpt``, ``--chunkalign_ckpt``, ``--roberta_ckpt`` and a
    cold-start ``--modcr_ckpt`` reach ``assemble_from_files`` and give the
    JAX graft's report; --do_test then writes its predictions."""
    reports = []
    orig = trun_pmr.assemble_from_files
    monkeypatch.setattr(trun_pmr, "assemble_from_files",
                        lambda *a, **kw: reports.append(orig(*a, **kw)) or reports[-1])
    argv = _port_argv(data, "port_split", "--do_test", "--test_file", data["paths"]["test"],
                      "--oscar_ckpt", split_files["oscar"], "--chunkalign_ckpt",
                      split_files["chunkalign"], "--roberta_ckpt", split_files["roberta"],
                      "--cold_start")
    argv[argv.index("--modcr_ckpt") + 1] = split_files["modcr"]
    trun_pmr.main(argv)
    fresh = jax.tree.map(np.asarray, data["params"])
    jreport = jassemble.assemble_from_files(
        fresh, data["cfg"], oscar_path=split_files["oscar"],
        chunkalign_path=split_files["chunkalign"], roberta_path=split_files["roberta"],
        modcr_path=split_files["modcr"], cold_start=True)
    assert len(reports) == 1 and reports[0].summary() == jreport.summary()
    assert set(reports[0].skipped) == set(jreport.skipped)
    assert any("cold-start" in why for why in reports[0].skipped.values())
    assert len(_predictions(data, "port_split")) == 6


REFUSED = [
    (["--quantize", "int8"], "--quantize int8", 6),
    (["--mesh_data", "2"], "--mesh_data", 9),
    (["--mesh_model", "2"], "--mesh_model", 9),
    (["--multihost"], "--multihost", 9),
    (["--device_features"], "--device_features", 9),
    (["--profile_dir", "prof"], "--profile_dir", 9),
    (["--tensorboard_dir", "tb"], "--tensorboard_dir", 9),
    (["--bert_tokenizer_dir", "bert"], "--bert_tokenizer_dir", 11),
    (["--roberta_tokenizer_dir", "rob"], "--roberta_tokenizer_dir", 11),
]


@pytest.mark.parametrize("flags,name,item", REFUSED, ids=[r[1] for r in REFUSED])
def test_unported_flags_are_refused_before_any_data_is_read(tmp_path, flags, name, item):
    argv = ["--do_test", "--device", "cpu", "--test_file", str(tmp_path / "absent.jsonl"),
            "--img_feat_file", str(tmp_path / "absent.pkl"),
            "--output_dir", str(tmp_path / "out"), *flags]
    with pytest.raises(SystemExit, match=rf"{name}.*ROADMAP Queue 1 item {item}\)"):
        trun_pmr.main(argv)
    assert not (tmp_path / "out").exists()


def test_long_image_lengths_run_on_every_device(data, monkeypatch):
    """Past the 192 keys the bf16 tensor-core kernels once held:
    --max_img_seq_length 60 (140 text + 60 regions = 200 keys) builds a bf16
    config on the card (the default device) and on the CPU, nothing refuses
    it up front, and run_pmr --do_test --tiny runs from a model directory
    whose config.json has a longer image length than the tiny default."""
    parse = tcommon.build_arg_parser("pmr").parse_args
    for flags in ([], ["--device", "cpu"]):
        cfg, _ = tcommon.configs_from_args(parse(["--max_img_seq_length", "60", *flags]))
        assert cfg.seq_len == 200 and cfg.global_encoder.dtype == "bfloat16"
    assert not hasattr(tcommon, "check_kernel_limits")

    cfg = dataclasses.replace(TConfig.tiny(), img_len=TConfig.tiny().img_len + 6)
    model_dir = data["dir"] / "long_img_model"
    save_config(str(model_dir), "config.json", cfg)
    CheckpointManager(str(model_dir / "ckpt"), params_only=True).save(
        types.SimpleNamespace(model=TModel(cfg, device="cpu"), step=1), {"accuracy": 1.0})
    img_lens = []
    step = trun_pmr.eval_step
    monkeypatch.setattr(trun_pmr, "eval_step",
                        lambda model, batch: (img_lens.append(batch["img_feat"].shape[1]),
                                              step(model, batch))[1])
    trun_pmr.main(["--do_test", "--tiny", "--device", "cpu",
                   "--test_file", data["paths"]["test"], "--img_feat_file", data["paths"]["pkl"],
                   "--eval_model_dir", str(model_dir),
                   "--output_dir", str(data["dir"] / "long_img")])
    assert img_lens and set(img_lens) == {cfg.img_len}
    assert len(_predictions(data, "long_img")) == 6


def test_the_commands_run_on_the_card_unless_asked_for_the_cpu(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    argv = _argv(data, "no_card", "--do_test", "--test_file", data["paths"]["test"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trun_pmr.main(argv)


def test_configs_match_the_jax_cli():
    """Each model and training flag sets the same config fields as the JAX
    CLI's configs_from_args."""
    argv = ["--do_train", "--max_seq_length", "120", "--max_img_seq_length", "40",
            "--num_labels", "3", "--img_feature_dim", "1030", "--drop_out", "0.2",
            "--skip_alignment_loss", "--remat", "--remat_policy", "full",
            "--flash_attention", "--scan_layers", "--learning_rate", "3e-5",
            "--gradient_accumulation_steps", "2", "--scheduler", "constant"]
    jcfg, jtcfg = jcommon.configs_from_args(jcommon.build_arg_parser("pmr").parse_args(argv))
    tcfg, ttcfg = tcommon.configs_from_args(tcommon.build_arg_parser("pmr").parse_args(argv))
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    assert dataclasses.asdict(ttcfg) == dataclasses.asdict(jtcfg)
    jflags = {a.dest: a.default for a in jcommon.build_arg_parser("pmr")._actions}
    tflags = {a.dest: a.default for a in tcommon.build_arg_parser("pmr")._actions}
    assert set(tflags) - set(jflags) == {"device"} and tflags.pop("device") == "cuda"
    assert tflags == jflags


def _vocab_args(tmp_path, vocab_name, content, merges=""):
    vocab = tmp_path / vocab_name
    vocab.write_text(content)
    argv = ["--roberta_vocab_file", str(vocab)]
    if merges:
        (tmp_path / "merges.txt").write_text(merges)
        argv += ["--roberta_merges_file", str(tmp_path / "merges.txt")]
    return tcommon.build_arg_parser("pmr").parse_args(argv)


def test_byte_bpe_vocab_without_merges_is_refused(tmp_path):
    """A byte-BPE vocab.json without --roberta_merges_file raises (the JAX
    CLI reads it as a WordPiece vocab of a few dozen ids); with merges it
    loads as byte-BPE, and a one-token-per-line vocab as WordPiece."""
    cfg = TConfig()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "a": 4, "b": 5, "ab": 6}
    args = _vocab_args(tmp_path, "vocab.json", json.dumps(vocab))
    with pytest.raises(ValueError, match="byte-BPE vocab.json.*--roberta_merges_file"):
        tcommon.load_tokenizers(args, cfg)
    # the JAX CLI takes the same file without an error, as a tiny vocab
    _, j_rob = jcommon.load_tokenizers(args, JConfig())
    assert len(j_rob) < 60
    _, rob = tcommon.load_tokenizers(
        _vocab_args(tmp_path, "vocab.json", json.dumps(vocab), merges="#version: 0.2\na b\n"),
        cfg)
    assert type(rob).__name__ == "ByteBPETokenizer" and rob.tokenize("ab") == ["ab"]
    _, rob = tcommon.load_tokenizers(
        _vocab_args(tmp_path, "vocab.txt", "\n".join(["<s>", "<pad>", "</s>", "<unk>", "ab"])),
        cfg)
    assert type(rob).__name__ == "WordPieceTokenizer" and rob.cls_token == "<s>"
