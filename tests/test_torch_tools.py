"""PyTorch port, the offline tools: ``cli/build_chunk_masks.py`` (both
formats, heuristic tagger), ``cli/pack_features.py``, the native ``.mcrpack``
reader, ``data/tsv.py``, ``utils/itm_eval.py`` and
``cli/export_reference.py``, each held against the JAX package's tool on
the same inputs: equal pickles, equal pack bytes, native lookups equal to
the Python reader's, equal TSV bytes and rows, an equal R@K dict, and an
exported ``.pth`` whose ``net`` holds every tensor of the JAX export and
loads into the port's model with ``strict=True``.  The ``--chunker_dir``
tagger needs ``transformers``: tests/test_torch_hf_tokenizer.py holds it.
"""

import pickle
import types

import jax
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.cli import build_chunk_masks as jchunks
from multimodal_context_reasoning_tpu.cli import pack_features as jpack
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import tsv as jtsv
from multimodal_context_reasoning_tpu.interop.export import save_reference_checkpoint
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.utils.itm_eval import itm_eval as jitm_eval
from multimodal_context_reasoning_torch.cli import build_chunk_masks as tchunks
from multimodal_context_reasoning_torch.cli import export_reference as texport
from multimodal_context_reasoning_torch.cli import pack_features as tpack
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.data import feature_store as tstore
from multimodal_context_reasoning_torch.data import tsv as ttsv
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.synthetic import (
    region_features,
    task_rows,
    write_rows,
)
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager, save_config
from multimodal_context_reasoning_torch.utils.itm_eval import itm_eval
from tests.test_torch_models import make_batch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the test off the cores the other workers
    use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    pmr, vcr = task_rows(rng, 6, 10), task_rows(rng, 4, 10, vcr=True, first=50)
    write_rows(str(d / "pmr.jsonl"), pmr)
    write_rows(str(d / "vcr.json"), vcr)
    feats = region_features(rng, pmr + vcr, 10, 12)
    feats["img-ragged"] = rng.standard_normal((3, 12), dtype=np.float32)
    with open(d / "feats.pkl", "wb") as f:
        pickle.dump({k: {"features": v} for k, v in feats.items()}, f)
    with open(d / "feats_torch.pkl", "wb") as f:
        pickle.dump({k: torch.from_numpy(v) for k, v in feats.items()}, f)
    return dict(dir=d, feats=feats)


def _same_tree(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("fmt", ["gather", "reference"])
@pytest.mark.parametrize("task", ["pmr", "vcr"])
def test_build_chunk_masks_writes_the_jax_pickle(files, fmt, task):
    d = files["dir"]
    src = str(d / ("pmr.jsonl" if task == "pmr" else "vcr.json"))
    out = {}
    for name, tool in (("jax", jchunks), ("port", tchunks)):
        path = d / f"chunks_{name}_{task}_{fmt}.pkl"
        tool.main(["--examples", src, "--task", task, "--format", fmt, "--out", str(path)])
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    _same_tree(out["port"], out["jax"])
    assert len(out["port"]) == (6 if task == "pmr" else 4)


def test_dense_mask_from_offsets_equals_jax():
    offsets = [[1, 2], [3], [4, 5, 6]]
    np.testing.assert_array_equal(tchunks.dense_mask_from_offsets(offsets, 8),
                                  jchunks.dense_mask_from_offsets(offsets, 8))


@pytest.mark.parametrize("source", ["feats.pkl", "feats_torch.pkl"])
def test_pack_features_writes_the_jax_bytes(files, source):
    d = files["dir"]
    for name, tool in (("jax", jpack), ("port", tpack)):
        tool.main(["--pickle", str(d / source), "--out", str(d / f"{name}_{source}.mcrpack")])
    assert ((d / f"port_{source}.mcrpack").read_bytes()
            == (d / f"jax_{source}.mcrpack").read_bytes())


@pytest.fixture(scope="module")
def pack(files):
    path = str(files["dir"] / "store.mcrpack")
    tstore.write_pack(files["feats"], path)
    return path


def _assert_lookups_equal(native, python, feats):
    assert native.native and not python.native
    assert sorted(native.keys()) == sorted(python.keys()) == sorted(feats)
    assert len(native) == len(python) == len(feats)
    for key, want in feats.items():
        got = native[key].features
        np.testing.assert_array_equal(got, python[key].features)
        np.testing.assert_array_equal(got, want)
        assert native[key].num_regions == want.shape[0]
    assert "absent" not in native and "absent" not in python
    native.close()
    python.close()


def test_native_lookups_equal_the_python_reader(pack, files):
    _assert_lookups_equal(tstore.FeatureStore(pack),
                          tstore.FeatureStore(pack, prefer_native=False), files["feats"])


def test_native_views_are_read_only_and_pin_their_reader(pack):
    store = tstore.FeatureStore(pack)
    key = next(iter(store.keys()))
    view = store[key].features
    assert not view.flags.writeable and not view.flags.owndata
    with pytest.raises(ValueError):
        view[0, 0] = 1.0
    reader = store._reader
    del store
    assert view._mcr_reader is reader and np.isfinite(view).all()


def test_native_library_builds_from_source_when_the_committed_one_fails(
        pack, files, tmp_path, monkeypatch):
    """A committed library that does not load is rebuilt from
    native/feature_store.cpp with the Makefile's flags into the build
    directory; the built reader gives the same rows."""
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "libmcr_feature_store.so").write_bytes(b"not a library")
    (broken / "feature_store.cpp").write_bytes(
        (tstore.NATIVE_DIR / "feature_store.cpp").read_bytes())
    monkeypatch.setattr(tstore, "NATIVE_DIR", broken)
    monkeypatch.setattr(tstore, "NATIVE_BUILD_DIR", tmp_path / "build")
    _assert_lookups_equal(tstore.FeatureStore(pack),
                          tstore.FeatureStore(pack, prefer_native=False), files["feats"])
    assert (tmp_path / "build" / "libmcr_feature_store.so").exists()


def test_a_library_that_fails_is_an_error_not_a_fallback(pack, tmp_path, monkeypatch):
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "libmcr_feature_store.so").write_bytes(b"not a library")
    monkeypatch.setattr(tstore, "NATIVE_DIR", broken)
    with pytest.raises(OSError):
        tstore.FeatureStore(pack)
    monkeypatch.setattr(tstore, "NATIVE_DIR", tmp_path / "nothing")
    store = tstore.FeatureStore(pack)
    assert not store.native                         # no library: the Python reader
    store.close()


def test_tsv_files_and_rows_equal_jax(tmp_path):
    rows = [["k2", "a b", 3], ["k0", "ü", b"raw"], ["k1", "", 0.5]]
    for name, mod in (("jax", jtsv), ("port", ttsv)):
        mod.tsv_writer(rows, str(tmp_path / name / "x.tsv"))
        mod.concat_tsv_files([str(tmp_path / name / "x.tsv")] * 2,
                             str(tmp_path / name / "cat.tsv"))
        mod.reorder_tsv_keys(str(tmp_path / name / "x.tsv"), ["k0", "k1", "k2"],
                             str(tmp_path / name / "sorted.tsv"))
    for fname in ("x.tsv", "x.lineidx", "cat.tsv", "cat.lineidx", "sorted.tsv"):
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "jax" / fname).read_bytes()
    got, want = ttsv.TSVFile(str(tmp_path / "port" / "cat.tsv")), jtsv.TSVFile(
        str(tmp_path / "jax" / "cat.tsv"))
    assert len(got) == len(want) == 6
    assert [got[i] for i in range(6)] == [want[i] for i in range(6)]
    got.close()
    want.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_itm_eval_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n_img = 12
    gold = rng.integers(0, n_img, 30)
    scores = rng.standard_normal((30, n_img)).astype(np.float32)
    scores[np.arange(30), gold] += rng.random(30) * 2
    assert itm_eval(scores, gold) == jitm_eval(scores, gold)
    assert itm_eval(scores, gold, ks=(1, 3)) == jitm_eval(scores, gold, ks=(1, 3))


def test_export_reference_writes_the_jax_tensors_and_loads_strictly(tmp_path):
    jcfg, cfg = JConfig.tiny(), TConfig.tiny()
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0), make_batch(jcfg))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = TModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    run = tmp_path / "run"
    save_config(str(run), "config.json", cfg)
    CheckpointManager(str(run / "ckpt"), params_only=True).save(
        types.SimpleNamespace(model=model, step=3), {"accuracy": 0.5})
    texport.main(["--eval_model_dir", str(run), "--out", str(tmp_path / "port.pth")])
    save_reference_checkpoint(str(tmp_path / "jax.pth"), params, jcfg)

    got = torch.load(tmp_path / "port.pth", weights_only=True)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert set(got) == set(want) == {"net"}
    assert set(want["net"]) <= set(got["net"])
    for k, w in want["net"].items():
        assert torch.equal(got["net"][k], w), k
    TModel(cfg, device="cpu").load_state_dict(got["net"], strict=True)
