"""PyTorch port, serving layer: featurize + collate bit-equal to the JAX
package, the port's ModCRScorer against the JAX ModCRScorer on the same
requests and weights, and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import collate as jcollate
from multimodal_context_reasoning_tpu.data import pmr as jpmr
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.serving.scorer import ModCRScorer as JScorer
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.data import collate as tcollate
from multimodal_context_reasoning_torch.data import pmr as tpmr
from multimodal_context_reasoning_torch.data import schemas as tschemas
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer as TScorer

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
PREMISES = [
    "<|det0|> and <|det2|> are talking near the car , while <|det1|> waits .",
    "the dog <|det3|> runs after a ball in the park .",
    "two people sit at a table with cups of coffee .",
]
ANSWERS = [
    ["they are friends .", "<|det0|> is angry at <|det1|> .", "it rains .",
     "the car is flying ."],
    ["the dog is happy .", "<|det3|> sleeps .", "nobody plays .", "a cat , a ball ."],
    ["they drink coffee .", "the table is empty .", "they shout .", "it is night ."],
]


def _features(schemas, dim, seed=0):
    rng = np.random.default_rng(seed)
    return {
        f"img-{i}": schemas.ImageFeatures(
            features=rng.normal(size=(3 + i, dim)).astype(np.float32),
            num_regions=3 + i)
        for i in range(3)
    }


def _examples(schemas, n=5):
    return [
        schemas.RawExample(
            example_id=f"e{i}", img_id=f"img-{i % 3}",
            premise=PREMISES[i % 3], answer_choices=ANSWERS[i % 3],
            answer_label=[0, 2] if i % 2 else i % 4,
        )
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def setup():
    # long enough streams that every answer survives truncation
    geometry = dict(text_len=40, roberta_len=80)
    jcfg = dataclasses.replace(JConfig.tiny(), **geometry)
    tcfg = dataclasses.replace(TConfig.tiny(), **geometry)
    dim = jcfg.global_encoder.img_feature_dim
    vocab = dict(bert=jcfg.global_encoder.vocab_size, rob=jcfg.roberta.vocab_size)
    jside = dict(
        feats=_features(jschemas, dim), examples=_examples(jschemas),
        bert=jtok.HashTokenizer(vocab_size=vocab["bert"]),
        rob=jtok.RobertaHashTokenizer(vocab_size=vocab["rob"]))
    tside = dict(
        feats=_features(tschemas, dim), examples=_examples(tschemas),
        bert=ttok.HashTokenizer(vocab_size=vocab["bert"]),
        rob=ttok.RobertaHashTokenizer(vocab_size=vocab["rob"]))
    spec_kw = dict(text_len=jcfg.text_len, img_len=jcfg.img_len,
                   roberta_len=jcfg.roberta_len, img_feature_dim=dim)
    jds = jpmr.PMRDataset([], jside["feats"], jside["bert"], jside["rob"],
                          spec=jcollate.BatchSpec(**spec_kw), max_chunks=jcfg.max_chunks)
    tds = tpmr.PMRDataset([], tside["feats"], tside["bert"], tside["rob"],
                          spec=tcollate.BatchSpec(**spec_kw), max_chunks=tcfg.max_chunks)
    jbatch = jcollate.collate_candidates(
        [jds.featurize(ex) for ex in jside["examples"]],
        [jds.get_image(ex) for ex in jside["examples"]], jds.spec)
    tbatch = tcollate.collate_candidates(
        [tds.featurize(ex) for ex in tside["examples"]],
        [tds.get_image(ex) for ex in tside["examples"]], tds.spec)
    params = jax.tree.map(np.asarray, jax.jit(JModel(jcfg).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in jbatch.items()}))
    return dict(jcfg=jcfg, tcfg=tcfg, j=jside, t=tside, jbatch=jbatch,
                tbatch=tbatch, params=params)


def test_featurize_and_collate_bit_equal(setup):
    jb, tb = setup["jbatch"], setup["tbatch"]
    assert set(jb) == set(tb)
    for key in jb:
        assert jb[key].dtype == tb[key].dtype, key
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    assert (tb["align_pos"].sum() > 0) and (tb["gather_index"].max() >= 0)


def test_scorer_matches_jax_scorer(setup):
    j, t = setup["j"], setup["t"]
    jscorer = JScorer(setup["jcfg"], setup["params"], j["bert"], j["rob"], j["feats"],
                      micro_batch=2)
    tscorer = TScorer(setup["tcfg"], params_from_jax(setup["params"], setup["tcfg"]),
                      t["bert"], t["rob"], t["feats"], micro_batch=2, device="cpu")
    want, got = jscorer.score(j["examples"]), tscorer.score(t["examples"])
    assert [r["example_id"] for r in got] == [r["example_id"] for r in want]
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    np.testing.assert_allclose([r["logits"] for r in got],
                               [r["logits"] for r in want], **TOL)
    np.testing.assert_allclose([r["probs"] for r in got],
                               [r["probs"] for r in want], **TOL)
    assert all(np.ptp(r["logits"]) > 1e-4 for r in got)  # candidates differ


def test_scorer_chunks_and_pads_by_repetition(setup):
    t = setup["t"]
    sd = params_from_jax(setup["params"], setup["tcfg"])
    three = TScorer(setup["tcfg"], sd, t["bert"], t["rob"], t["feats"],
                    micro_batch=3, device="cpu")
    one = TScorer(setup["tcfg"], sd, t["bert"], t["rob"], t["feats"],
                  micro_batch=1, device="cpu")
    a, b = three.score(t["examples"]), one.score(t["examples"])
    assert len(a) == len(b) == len(t["examples"])
    np.testing.assert_allclose([r["logits"] for r in a], [r["logits"] for r in b],
                               rtol=1e-5, atol=1e-5)
    for r in a:
        np.testing.assert_allclose(sum(r["probs"]), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="micro_batch"):
        one.score_featurized([one.featurize(ex) for ex in t["examples"][:2]], ["x", "y"])


def test_scorer_bf16_casts_weights_once_and_stays_finite(setup):
    t = setup["t"]
    cfg = setup["tcfg"].with_dtype("bfloat16")
    scorer = TScorer(cfg, params_from_jax(setup["params"], cfg), t["bert"], t["rob"],
                     t["feats"], micro_batch=2, device="cpu")
    assert {p.dtype for p in scorer.model.parameters()} == {torch.bfloat16}
    rows = scorer.score(t["examples"][:2])
    assert np.isfinite([r["logits"] for r in rows]).all()


def test_scorer_defaults_to_cuda_and_refuses_without_it(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    t = setup["t"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TScorer(setup["tcfg"], params_from_jax(setup["params"], setup["tcfg"]),
                t["bert"], t["rob"], t["feats"])


def test_model_defaults_to_cuda_and_refuses_without_it(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(setup["tcfg"])
    assert TModel(setup["tcfg"], device="cpu").abst_confidence_scorer.weight.is_cpu


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import multimodal_context_reasoning_torch as p\n"
        "import chip_smoke\n"
        "from multimodal_context_reasoning_torch.cli import run_pmr, run_vcr, serve\n"
        "from multimodal_context_reasoning_torch.serving import batcher, server\n"
        "from multimodal_context_reasoning_torch.interop import assemble\n"
        "from multimodal_context_reasoning_torch.data import subword, rationale\n"
        "from multimodal_context_reasoning_torch.ops import quant\n"
        "from multimodal_context_reasoning_torch.models import gpt2\n"
        "from multimodal_context_reasoning_torch.models import rationale as rationale_model\n"
        "from multimodal_context_reasoning_torch.generation import api, decode\n"
        "from multimodal_context_reasoning_torch.serving import generator\n"
        "from multimodal_context_reasoning_torch.models import chunkalign_cls, oscar_heads\n"
        "from multimodal_context_reasoning_torch.interop import export\n"
        "from multimodal_context_reasoning_torch.data import mixed, task_processors\n"
        "from multimodal_context_reasoning_torch.cli import train_two_stage, train_real_pmr\n"
        "from multimodal_context_reasoning_torch.models import ensemble, clip, clip_ensemble\n"
        "from multimodal_context_reasoning_torch.data import clip_preprocess, clip_tokenizer\n"
        "from multimodal_context_reasoning_torch.cli import precompute_clip\n"
        "from multimodal_context_reasoning_torch.serving import aot\n"
        "from multimodal_context_reasoning_torch.data import device_table\n"
        "from multimodal_context_reasoning_torch.utils import profiling, tensorboard\n"
        "from multimodal_context_reasoning_torch.parallel import comm, mesh, partition\n"
        "from multimodal_context_reasoning_torch.parallel import multihost\n"
        "from multimodal_context_reasoning_torch.cli import build_chunk_masks, pack_features\n"
        "from multimodal_context_reasoning_torch.cli import export_reference\n"
        "from multimodal_context_reasoning_torch.data import tsv, feature_store\n"
        "from multimodal_context_reasoning_torch.utils import itm_eval\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'multimodal_context_reasoning_tpu'))\n"
        "assert not bad, bad\n"
        "# the card's machine may lack them: imported only where they are used\n"
        "host = sorted(n for n in sys.modules if n.split('.')[0] in ('PIL', 'regex'))\n"
        "assert not host, host\n"
        "# the card's machine has no tensorboard package: TensorboardLogger\n"
        "# imports it when it is built, never at import\n"
        "tb = sorted(n for n in sys.modules if n.split('.')[0] == 'tensorboard'\n"
        "            or n.startswith('torch.utils.tensorboard'))\n"
        "assert not tb, tb\n"
        "# transformers loads only for a tokenizer directory or --chunker_dir\n"
        "hf = sorted(n for n in sys.modules if n.split('.')[0] == 'transformers')\n"
        "assert not hf, hf[:5]\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 80
