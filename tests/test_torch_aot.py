"""PyTorch port, AOT serving artifacts (``serving/aot.py``) on the CPU at the
tiny geometry: ``serve --save_artifact`` then ``serve --artifact`` against
the JAX serve command on the same weights (2e-4, the port's tolerance
against JAX in fp32), the loaded program against the live scorer it was
exported from (bit-identical: the same aten ops and the same kernel ops in
the same order), weights swapped without a new export, table mode with a
smaller feature pack padded to the traced capacity, bf16 dtypes restored,
the HTTP batcher in front, the greedy generator artifact against live and
JAX generation (tokens equal), the refusals, and both loaders with the
model classes' constructors patched to raise (twins of JAX
tests/test_aot_artifact.py)."""

import json
import os
import shutil
import types
import zipfile

import pytest
import torch

from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data.pmr import PMRDataset as JPMR
from multimodal_context_reasoning_tpu.serving.scorer import build_host_batch as j_build_host_batch
from multimodal_context_reasoning_torch.cli import serve as tserve_cli
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.data import schemas as tschemas
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.models.rationale import RationaleModel
from multimodal_context_reasoning_torch.serving import aot
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer as TScorer
from multimodal_context_reasoning_torch.serving.server import serve as tserve
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager
from tests.test_torch_serving import (  # noqa: F401  (fixtures)
    _assert_same_generations,
    _assert_same_results,
    _body,
    _capture,
    _example,
    _features,
    _request,
    cli_files,
    gen_cli,
)

IDS = [0, 1, 2, 3, 5]


def _tokenizers(cfg):
    return (ttok.HashTokenizer(vocab_size=cfg.global_encoder.vocab_size),
            ttok.RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size))


def _features_of(cli_files):
    from multimodal_context_reasoning_torch.cli.common import load_image_features

    return load_image_features(cli_files["pkl"], TConfig.tiny().global_encoder.img_feature_dim)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side is tiny: one intra-op thread keeps it off the cores
    the other test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def scorer_art(cli_files, tmp_path_factory):
    """``serve --save_artifact`` over the model directory holding the JAX
    serve command's random init."""
    d = str(tmp_path_factory.mktemp("aot") / "scorer")
    tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--eval_model_dir", cli_files["model"],
                     "--micro_batch", "2", "--device", "cpu", "--save_artifact", d])
    return d


@pytest.fixture(scope="module")
def live(cli_files):
    """The live scorer the artifact was exported from: the same checkpoint,
    features and tokenizers."""
    cfg = TConfig.tiny()
    weights = CheckpointManager(os.path.join(cli_files["model"], "ckpt")).restore_params(
        best=True)
    return TScorer(cfg, weights, *_tokenizers(cfg), _features_of(cli_files), micro_batch=2,
                   device="cpu")


@pytest.fixture(scope="module")
def served(cli_files, scorer_art):
    """``serve --artifact``: what the command passed to serve(), and what it
    printed."""
    from multimodal_context_reasoning_torch.serving import server as tserver

    with pytest.MonkeyPatch.context() as mp:
        cap = _capture(mp, tserver)
        printed = []
        mp.setattr("builtins.print", lambda *a, **kw: printed.append(" ".join(map(str, a))))
        tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--artifact", scorer_art,
                         "--device", "cpu"])
    return dict(cap, printed=printed)


@pytest.fixture(scope="module")
def table_art(tmp_path_factory):
    """A bf16 device-table scorer over 4 images, and its artifact."""
    cfg = TConfig.tiny().with_dtype("bfloat16")
    model = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    feats = _features(tschemas, cfg.global_encoder.img_feature_dim)
    scorer = TScorer(cfg, model, *_tokenizers(cfg), feats, micro_batch=2, device="cpu",
                     use_device_table=True)
    d = str(tmp_path_factory.mktemp("aot") / "table")
    aot.save_scorer_artifact(d, scorer)
    return dict(dir=d, scorer=scorer, feats=feats, cfg=cfg)


@pytest.fixture(scope="module")
def gen_art(gen_cli, cli_files, tmp_path_factory):
    """``serve --generate --save_gen_artifact`` with gen_cli's command line
    (the reference .pth, fp32, greedy, 8 steps)."""
    d = str(tmp_path_factory.mktemp("aot") / "generator")
    gen = gen_cli["t"]["generator"]
    argv = ["--img_feat_file", cli_files["pkl"], "--tiny", "--compute_dtype", "float32",
            "--micro_batch", "2", "--generate", "--gen_micro_batch", "2",
            "--max_rationale_len", "8", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        # the reference .pth of gen_cli: its generator's own weights
        mp.setattr(tserve_cli, "build_generator", lambda *a: gen)
        tserve_cli.main(argv + ["--save_gen_artifact", d])
    return d


def _meta(d):
    with open(os.path.join(d, aot.META_FILE)) as f:
        return json.load(f)


def test_serve_artifact_scores_as_the_jax_cli(served, scorer_art, gen_cli):
    """serve --save_artifact, then serve --artifact: the command builds no
    model, takes its config and micro-batch from the artifact, and replies
    as the JAX serve command does on the same weights (the JAX command's
    tiny random init, which gen_cli's JAX command scores with too)."""
    assert any(f"serving AOT artifact {scorer_art}" in line for line in served["printed"])
    sc = served["scorer"]
    assert isinstance(sc, aot.AOTScorer) and sc.micro_batch == 2 and served["generator"] is None
    want = gen_cli["j"]["scorer"].score([_example(jschemas, i) for i in IDS])
    _assert_same_results(sc.score([_example(tschemas, i) for i in IDS]), want)


def test_aot_scorer_is_bit_identical_to_the_live_scorer(served, live):
    exs = [_example(tschemas, i) for i in IDS]
    assert served["scorer"].score(exs) == live.score(exs)


def test_artifact_records_the_jax_keys_and_the_real_signature(scorer_art, table_art,
                                                              cli_files):
    """artifact.json has JAX's keys (no compiled executable); batch_keys are
    the batch JAX's build_host_batch makes, plus the table's tensors in table
    mode; the program holds no weight and no sample input, and calls the
    stage-mask op."""
    meta, tmeta = _meta(scorer_art), _meta(table_art["dir"])
    for m in (meta, tmeta):
        assert {"kind", "config", "micro_batch", "param_dtypes", "batch_keys", "executable",
                "use_device_table", "table_capacity", "device"} <= set(m)
        assert m["kind"] == "scorer" and m["executable"] is None and m["device"] == "cpu"
    from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
    from multimodal_context_reasoning_tpu.data import tokenization as jtok
    from multimodal_context_reasoning_tpu.data.collate import BatchSpec as JSpec

    jcfg = JConfig.tiny()
    spec = JSpec(text_len=jcfg.text_len, img_len=jcfg.img_len, roberta_len=jcfg.roberta_len,
                 img_feature_dim=jcfg.global_encoder.img_feature_dim)
    ds = JPMR([], _features(jschemas, jcfg.global_encoder.img_feature_dim),
              jtok.HashTokenizer(vocab_size=256), jtok.RobertaHashTokenizer(vocab_size=256),
              spec=spec, max_chunks=jcfg.max_chunks)
    ex = _example(jschemas, 0)
    host = j_build_host_batch([(ds.featurize(ex), ds.get_image(ex))] * 2, spec, 4,
                              table_mode=False)
    table = j_build_host_batch([(ds.featurize(ex), 0)] * 2, spec, 4, table_mode=True)
    assert meta["batch_keys"] == sorted(host)
    assert not meta["use_device_table"] and meta["table_capacity"] == 0
    assert tmeta["batch_keys"] == sorted([*table, "feat_table", "feat_mask_table"])
    assert tmeta["use_device_table"] and tmeta["table_capacity"] == 4
    program = torch.export.load(os.path.join(scorer_art, aot.PROGRAM_FILE))
    assert not program.state_dict and not program.constants
    with zipfile.ZipFile(os.path.join(scorer_art, aot.PROGRAM_FILE)) as z:
        held = [(i.filename, i.file_size) for i in z.infolist()
                if ("sample_inputs" in i.filename or "/weights/" in i.filename
                    or "/constants/" in i.filename) and i.file_size > 64]
    assert not held
    ops = [n for n in program.graph.nodes if "modcr_torch" in str(n.target)]
    assert {str(n.target) for n in ops} == {"modcr_torch.spec_attention.default"}


def test_bf16_table_artifact_restores_dtypes_and_pads_a_smaller_pack(table_art):
    """The bf16 weights come back in bf16 (the recorded dtypes), the loaded
    program scores as the live table scorer, and a feature pack smaller than
    the traced capacity is padded to it; a larger one is refused."""
    cfg, scorer = table_art["cfg"], table_art["scorer"]
    meta = _meta(table_art["dir"])
    feats = table_art["feats"]
    small = {k: feats[k] for k in ("img-1", "img-3")}
    loaded = aot.AOTScorer(table_art["dir"], *_tokenizers(cfg), small)
    live = {k: str(v.dtype).replace("torch.", "") for k, v in scorer.model.state_dict().items()}
    assert meta["param_dtypes"] == live
    assert {str(v.dtype) for v in loaded.params.values()} == {"torch.bfloat16"}
    assert all(str(loaded.params[k].dtype) == f"torch.{d}" for k, d in live.items())
    assert tuple(loaded.table.table.shape[:1]) == (4,) and loaded.table.table.dtype == torch.bfloat16
    exs = [_example(tschemas, i) for i in (1, 3, 5)]
    got = loaded.score(exs)
    assert [r["logits"] for r in got] == [r["logits"] for r in scorer.score(exs)]
    five = dict(feats, **{"img-9": feats["img-0"]})
    with pytest.raises(ValueError, match="exceed the table capacity 4"):
        aot.AOTScorer(table_art["dir"], *_tokenizers(cfg), five)


def test_weights_swap_without_a_new_export(scorer_art, live, cli_files, tmp_path):
    """Another state dict of the same keys written into params.pt (in fp32
    carriers, cast back to the recorded dtypes) serves through the same
    program as a live scorer on those weights."""
    d = str(tmp_path / "swapped")
    shutil.copytree(scorer_art, d)
    cfg = TConfig.tiny()
    other = TModel(cfg, device="cpu", generator=torch.Generator().manual_seed(11))
    torch.save({k: v.double() for k, v in other.state_dict().items()},
               os.path.join(d, aot.PARAMS_FILE))
    feats = _features_of(cli_files)
    loaded = aot.AOTScorer(d, *_tokenizers(cfg), feats)
    assert {str(v.dtype) for v in loaded.params.values()} == {"torch.float32"}
    want = TScorer(cfg, other, *_tokenizers(cfg), feats, micro_batch=2, device="cpu")
    exs = [_example(tschemas, i) for i in IDS]
    got = loaded.score(exs)
    assert got == want.score(exs) and got != live.score(exs)


def test_aot_scorer_serves_behind_the_micro_batcher(served, live):
    server = tserve(served["scorer"], port=0, block=False)
    try:
        code, out, _ = _request(server.server_address[1], "/score", _body(IDS))
    finally:
        server.modcr_close()
    assert code == 200
    assert out["results"] == live.score([_example(tschemas, i) for i in IDS])


def test_generator_artifact_decodes_as_live_and_jax(gen_cli, gen_art, cli_files, monkeypatch):
    """serve --gen_artifact beside a live scorer: the greedy tokens and the
    probabilities equal the live generator's, and the JAX command's (tokens
    equal, probabilities within 2e-4); the artifact records JAX's keys."""
    from multimodal_context_reasoning_torch.serving import server as tserver

    meta = _meta(gen_art)
    assert {"kind", "spec", "num_labels", "max_chunks", "micro_batch", "max_rationale_len",
            "b_rtnl", "e_rtnl", "gpt_vocab_size", "bert_vocab_size", "param_dtypes",
            "executable", "device"} <= set(meta)
    assert meta["kind"] == "generator" and meta["max_rationale_len"] == 8
    tcap = _capture(monkeypatch, tserver)
    tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--tiny", "--micro_batch", "2",
                     "--device", "cpu", "--gen_artifact", gen_art])
    loaded = tcap["generator"]
    assert isinstance(loaded, aot.AOTGenerator)
    tgen, jgen = gen_cli["t"]["generator"], gen_cli["j"]["generator"]
    exs = [_example(tschemas, i) for i in IDS]
    got = loaded.generate(exs)
    assert got == tgen.generate(exs)
    _assert_same_generations(got, jgen.generate([_example(jschemas, i) for i in IDS]))
    assert len({tuple(r["rationale_ids"]) for r in got}) > 1


def test_generator_refusals_and_the_kind_cross_check(gen_cli, gen_art, scorer_art, cli_files):
    feats = _features_of(cli_files)
    tgen = gen_cli["t"]["generator"]
    bert = ttok.HashTokenizer(vocab_size=256)
    with pytest.raises(ValueError, match=r"tokenizer maps rationale markers to .* but the "
                                         r"artifact was exported with"):
        aot.AOTGenerator(gen_art, bert, ttok.HashTokenizer(vocab_size=96), feats)
    sampler = types.SimpleNamespace(mode="sample")
    with pytest.raises(NotImplementedError, match="only the fused greedy program exports"):
        aot.save_generator_artifact(str(os.path.join(gen_art, "never")), sampler)
    with pytest.raises(ValueError, match="holds a 'generator' artifact, not a scorer"):
        aot.AOTScorer(gen_art, *_tokenizers(TConfig.tiny()), feats)
    with pytest.raises(ValueError, match="holds a 'scorer' artifact, not a generator"):
        aot.AOTGenerator(scorer_art, bert, tgen.gpt_tokenizer, feats)


def test_loaders_construct_no_model(scorer_art, gen_art, live, gen_cli, cli_files, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a loader constructed a model")

    monkeypatch.setattr(TModel, "__init__", refuse)
    monkeypatch.setattr(RationaleModel, "__init__", refuse)
    feats = _features_of(cli_files)
    exs = [_example(tschemas, i) for i in (0, 1, 2)]
    scorer = aot.AOTScorer(scorer_art, *_tokenizers(TConfig.tiny()), feats)
    assert scorer.score(exs) == live.score(exs)
    tgen = gen_cli["t"]["generator"]
    gen = aot.AOTGenerator(gen_art, ttok.HashTokenizer(vocab_size=256), tgen.gpt_tokenizer,
                           feats)
    assert gen.generate(exs) == tgen.generate(exs)


def test_a_cuda_artifact_needs_a_card(scorer_art, cli_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = str(tmp_path / "cuda")
    shutil.copytree(scorer_art, d)
    meta = _meta(d)
    meta["device"] = "cuda"
    with open(os.path.join(d, aot.META_FILE), "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aot.AOTScorer(d, *_tokenizers(TConfig.tiny()), _features_of(cli_files))
    with pytest.raises(SystemExit, match="exported on cuda"):
        tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--artifact", d,
                         "--device", "cpu"])
