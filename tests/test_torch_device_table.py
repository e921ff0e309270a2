"""PyTorch port, the device-resident feature table (``data/device_table.py``)
held against the JAX package's at ``ModCRConfig.tiny()`` on the CPU: its
batches, its rows and its capacity rule, and the gather on the device
against host-collated features, in the port (1e-6 relative, JAX's own
bound in tests/test_device_table.py) and against JAX's table mode on the
same weights carried across by ``params_from_jax`` (2e-4, the port's
tolerance against JAX in fp32).  Also ``MixedDataset`` on one table, the
trainer keeping the table where it is, and ``run_pmr --device_features
--profile_dir --tensorboard_dir``."""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.cli.common import batch_spec as jbatch_spec
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.data.device_table import (
    TABLE_KEYS as J_TABLE_KEYS,
)
from multimodal_context_reasoning_tpu.data.device_table import (
    DeviceFeatureTable as JTable,
)
from multimodal_context_reasoning_tpu.data.pmr import PMRDataset as JPMR
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.train.optim import make_optimizer
from multimodal_context_reasoning_tpu.train.state import TrainState as JState
from multimodal_context_reasoning_tpu.train.step import make_eval_step, make_train_step
from multimodal_context_reasoning_torch.cli import run_pmr as trun_pmr
from multimodal_context_reasoning_torch.cli.common import batch_spec
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.data import schemas as tschemas
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.data.device_table import TABLE_KEYS, DeviceFeatureTable
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.mixed import MixedDataset
from multimodal_context_reasoning_torch.data.pmr import PMRDataset
from multimodal_context_reasoning_torch.data.vcr import VCRDataset
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.serving.synthetic import region_features, task_rows, write_rows
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import eval_step, train_step
from multimodal_context_reasoning_torch.train.trainer import Trainer

TOL = dict(rtol=2e-4, atol=2e-4)
TCFG = dict(learning_rate=1e-3, scheduler="constant", per_device_batch_size=4)


def _config(cls):
    # every dropout at 0: the JAX and torch dropout streams differ
    return dataclasses.replace(cls.tiny(), mapping_dropout=0.0)


def _examples(schemas):
    return [schemas.RawExample(f"e{i}", f"img-{i % 3}", f"premise {i} about people .",
                               [f"answer {i} {j} ." for j in range(4)], i % 4)
            for i in range(6)]


def _features(schemas, dim):
    rng = np.random.default_rng(0)
    return {f"img-{i}": schemas.ImageFeatures(
        features=rng.normal(size=(3 + i, dim)).astype(np.float32), num_regions=3 + i)
        for i in range(3)}



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side is tiny: one intra-op thread keeps it off the cores
    the other test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def setup():
    """Both packages' datasets on the same examples and features, an fp32
    table on each side (the equality with host features is then exact), the
    JAX weights, and the port's batches in both modes."""
    jcfg, tcfg = _config(JConfig), _config(TConfig)
    dim = jcfg.global_encoder.img_feature_dim
    vocab = dict(vocab_size=jcfg.global_encoder.vocab_size)
    rob = dict(vocab_size=jcfg.roberta.vocab_size)
    jfeats, tfeats = _features(jschemas, dim), _features(tschemas, dim)
    jtable = JTable(jfeats, img_len=jcfg.img_len, dtype="float32")
    ttable = DeviceFeatureTable(tfeats, img_len=tcfg.img_len, dtype="float32", device="cpu")

    def jds(table=None):
        ds = JPMR(_examples(jschemas), jfeats, jtok.HashTokenizer(**vocab),
                  jtok.HashTokenizer(**rob), spec=jbatch_spec(jcfg), max_chunks=jcfg.max_chunks)
        if table is not None:
            ds.use_device_table(table)
        return ds

    def tds(table=None, cls=PMRDataset):
        ds = cls(_examples(tschemas), tfeats, ttok.HashTokenizer(**vocab),
                 ttok.HashTokenizer(**rob), spec=batch_spec(tcfg), max_chunks=tcfg.max_chunks)
        if table is not None:
            ds.use_device_table(table)
        return ds

    jhost = jds().batch(range(4))
    model = JModel(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in jhost.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, jtable=jtable, ttable=ttable, jds=jds, tds=tds,
                jmodel=model, params=jax.tree.map(np.asarray, params),
                host=tds().batch(range(4)), dev=tds(ttable).batch(range(4)),
                jdev=jds(jtable).batch(range(4)), tfeats=tfeats)


def _torch(batch):
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            for k, v in batch.items()}


def _port_model(s):
    model = ModCRModel(s["tcfg"], device="cpu")
    model.load_state_dict(params_from_jax(s["params"], s["tcfg"]), strict=True)
    return model


def test_batch_schema_matches_jax(setup):
    """The same keys, dtypes, shapes and row ids as JAX's table batches; the
    candidate rows of one example share their row; the table is the same
    tensor in every batch."""
    s = setup
    dev, jdev = s["dev"], s["jdev"]
    assert TABLE_KEYS == J_TABLE_KEYS
    assert set(dev) == set(jdev) and "img_feat" not in dev and "img_mask" not in dev
    for key, want in jdev.items():
        got = dev[key]
        if key in TABLE_KEYS:
            assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape, key
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=key)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert dev["img_row"].shape == (16,) and len(set(dev["img_row"][:4].tolist())) == 1
    again = s["tds"](s["ttable"]).batch(range(2))
    assert again["feat_table"] is s["ttable"].table
    assert again["feat_mask_table"] is s["ttable"].mask


def test_table_rows_follow_jax_and_the_config_dtype(setup):
    """Rows in sorted-key order, features and masks as JAX's table; the
    nbytes of both tensors; ``for_config`` keeps fp32 under fp32 compute and
    bf16 under bf16 compute, as JAX's does."""
    s = setup
    t, j = s["ttable"], s["jtable"]
    assert t.row == j.row
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert t.nbytes == j.nbytes
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = s["tcfg"].with_dtype(dtype)
        table = DeviceFeatureTable.for_config(s["tfeats"], cfg, device="cpu")
        jtable = JTable.for_config(_features(jschemas, cfg.global_encoder.img_feature_dim),
                                   s["jcfg"].with_dtype(dtype))
        assert table.table.dtype == want and table.mask.dtype == torch.float32
        assert str(jtable.table.dtype) == dtype
        np.testing.assert_array_equal(table.table.float().numpy(),
                                      np.asarray(jtable.table.astype(jnp.float32)))


def test_row_for_reference_key_quirk(setup):
    t = setup["ttable"]
    assert t.row_for("img-1") == t.row_for("somesplit-1") == setup["jtable"].row_for("x-1")


def test_capacity_pads_rows_and_refuses_a_larger_set(setup):
    feats = setup["tfeats"]
    padded = DeviceFeatureTable(feats, img_len=8, dtype="float32", capacity=5, device="cpu")
    assert tuple(padded.table.shape[:2]) == (5, 8) and padded.mask[3:].sum() == 0
    assert torch.equal(padded.table[:3], setup["ttable"].table)
    with pytest.raises(ValueError, match="exceed the table capacity 2") as err:
        DeviceFeatureTable(feats, img_len=8, capacity=2, device="cpu")
    with pytest.raises(ValueError) as jerr:
        JTable(_features(jschemas, 20), img_len=8, capacity=2)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="at least one image feature"):
        DeviceFeatureTable({}, img_len=8, device="cpu")


def test_eval_logits_equal_host_mode(setup):
    """JAX's test_eval_logits_equal: the gathered features give the host
    path's logits (1e-6 relative); they also agree with JAX's table mode."""
    s = setup
    model = _port_model(s)
    a = eval_step(model, _torch(s["host"]))["logits"]
    b = eval_step(model, _torch(s["dev"]))["logits"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    want = make_eval_step(s["jmodel"])(s["params"],
                                       {k: jnp.asarray(v) for k, v in s["jdev"].items()})
    np.testing.assert_allclose(b.numpy(), np.asarray(want["logits"]), **TOL)


def test_train_step_loss_and_grads_equal_host_mode(setup):
    """JAX's test_train_step_loss_and_grads_equal: one train step in each
    mode gives the same loss and gradient norm (1e-6 relative); the table
    mode's agree with JAX's table-mode step on the same weights (2e-4)."""
    s = setup
    got = {}
    for name in ("host", "dev"):
        model = _port_model(s)
        state = TrainState.create(model, TrainConfig(**TCFG), 10)
        m = train_step(state, _torch(s[name]))
        got[name] = (float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(got["host"], got["dev"], rtol=1e-6)
    tx = make_optimizer(JTrainConfig(**TCFG), 10, s["params"])
    step = make_train_step(s["jmodel"], donate=False)
    _, m = step(JState.create(s["params"], tx),
                {k: jnp.asarray(v) for k, v in s["jdev"].items()}, jax.random.PRNGKey(1))
    np.testing.assert_allclose(got["dev"], (float(m["loss"]), float(m["grad_norm"])), **TOL)


def test_trainer_keeps_the_table_where_it_is(setup):
    """The trainer's copy to the device leaves the resident table tensors as
    they are: the same objects, not copies."""
    s = setup
    trainer = Trainer(_port_model(s), TrainConfig(**TCFG),
                      DataLoader(s["tds"](s["ttable"]), 4), device="cpu")
    batch = trainer.to_device(s["dev"])
    assert batch["feat_table"] is s["ttable"].table
    assert batch["img_row"].dtype == torch.int32


def test_mixed_dataset_shares_one_table(setup):
    """MixedDataset over PMR and VCR children on one table: the mixture's
    batches carry that table, and their rows gather the host collate's
    features; children on different tables are refused."""
    s = setup
    table = s["ttable"]
    mixed = MixedDataset([s["tds"](), s["tds"](cls=VCRDataset)])
    host = mixed.batch([0, 7, 3, 11])
    mixed.use_device_table(table)
    assert all(d.device_table is table for d in mixed.datasets)
    dev = mixed.batch([0, 7, 3, 11])
    assert dev["feat_table"] is table.table and "img_feat" not in dev
    rows = torch.from_numpy(dev["img_row"]).long()
    np.testing.assert_array_equal(table.table[rows].numpy(), host["img_feat"])
    np.testing.assert_array_equal(table.mask[rows].numpy(), host["img_mask"])
    other = DeviceFeatureTable(s["tfeats"], img_len=8, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="disagree on device-table mode"):
        MixedDataset([s["tds"](table), s["tds"](other)])
    with pytest.raises(ValueError, match="disagree on device-table mode"):
        MixedDataset([s["tds"](table), s["tds"]()])


def test_run_pmr_trains_with_device_features_a_trace_and_scalars(tmp_path, monkeypatch):
    """run_pmr --do_train --tiny --device_features --profile_dir
    --tensorboard_dir: training reads the features from the table, the
    profiler writes a Chrome trace of steps 2-4 naming the stage-mask op
    and the program's spans, with the span table beside it, and the
    scalars reach the TensorBoard directory."""
    from multimodal_context_reasoning_torch.utils import profiling

    monkeypatch.setattr(profiling, "_ON", False)     # spans on for the capture alone
    profiling.reset_spans()
    rng = np.random.default_rng(1)
    rows = task_rows(rng, 24, 5, words=(1, 4))
    write_rows(str(tmp_path / "train.jsonl"), rows[:16])
    write_rows(str(tmp_path / "val.jsonl"), rows[16:])
    with open(tmp_path / "feats.pkl", "wb") as f:
        pickle.dump({k: {"features": v} for k, v in region_features(rng, rows, 5, 20).items()},
                    f)
    prof, tb = tmp_path / "prof", tmp_path / "tb"
    state = trun_pmr.main([
        "--do_train", "--tiny", "--device", "cpu", "--device_features",
        "--train_file", str(tmp_path / "train.jsonl"), "--val_file", str(tmp_path / "val.jsonl"),
        "--img_feat_file", str(tmp_path / "feats.pkl"), "--output_dir", str(tmp_path / "out"),
        "--per_gpu_train_batch_size", "2", "--per_gpu_eval_batch_size", "4",
        "--max_steps", "5", "--valid_steps", "5", "--epoch_begin", "1",
        "--profile_dir", str(prof), "--tensorboard_dir", str(tb)])
    assert state.step == 5
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1 and len(list(prof.glob("*.json"))) == 2
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("modcr_torch::spec_attention" in n for n in names)
    assert {"step.train", "step.backward", "step.optimizer", "model.roberta"} <= names
    spans = json.loads((prof / traces[0].name.replace("trace_", "spans_", 1)).read_text())
    assert spans["spans"]["step.train"]["count"] == 3
    assert spans["by_span"] == {}            # no card: no kernel, no idle
    written = [os.path.join(d, f) for d, _, fs in os.walk(tb) for f in fs]
    assert written and all(os.path.getsize(f) > 0 for f in written)
    assert {os.path.basename(os.path.dirname(f)) for f in written} >= {"last", "avg", "median"} \
        or any(f.endswith("metrics.jsonl") for f in written)


def test_trace_writes_a_chrome_trace_and_the_step_timer_counts(tmp_path):
    """utils/profiling.py: ``trace(None)`` does nothing; ``trace(dir)``
    writes one Chrome trace naming the ops run inside, and the program's
    span around them when spans are on."""
    from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec
    from multimodal_context_reasoning_torch.ops.masks import full_mask_spec
    from multimodal_context_reasoning_torch.utils.profiling import enable_spans, span, trace

    q = torch.randn(2, 6, 2, 8)
    spec = full_mask_spec(torch.ones(2, 6), 6)
    with trace(None) as prof:
        assert prof is None
    was = enable_spans(True)
    try:
        with trace(str(tmp_path)):
            with span("test.step"):
                fused_attention_spec(q, q, q, spec.valid, spec.gi, spec.rowfull, stage="full",
                                     text_len=6)
    finally:
        enable_spans(was)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any("modcr_torch::spec_attention" in n for n in names)
    assert "test.step" in names


def test_tensorboard_logger_falls_back_to_jsonl(tmp_path, monkeypatch):
    """Without the tensorboard package (``torch.utils.tensorboard`` fails to
    import) the logger writes the JAX module's JSONL triple instead."""
    import sys

    from multimodal_context_reasoning_torch.utils.metrics import MetricLogger
    from multimodal_context_reasoning_torch.utils.tensorboard import TensorboardLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = TensorboardLogger(str(tmp_path))
    assert tb.writer == "jsonl"
    meters = MetricLogger()
    meters.update(loss=2.0)
    meters.update(loss=1.0)
    tb.log_meters(meters, 3)
    tb.log_scalar("val_acc", 0.5, 3)
    tb.close()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0] == {**lines[0], "step": 3, "name": "loss", "last": 1.0, "avg": 1.5,
                        "median": 1.5}
    assert lines[1]["val_acc"] == 0.5 and lines[1]["step"] == 3
