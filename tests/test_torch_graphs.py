"""PyTorch port: the segmented CUDA graphs behind ``eval_step``
(``train/graphs.py``).

On the CPU a fake backend stands in for the CUDA graph calls, so the
bookkeeping runs without a card: when the graph engages, what its key
holds, where a capture cuts, what a replay copies and counts.  The tests
marked ``cuda`` hold replays to the eager forward at ``ModCRConfig()`` in
bf16 compute (``pmr_eval_b32``'s model) with seeded weights, 32 questions a
batch, on the card, and skip without one; the file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig, TrainConfig
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.ops.fused_attention import call_op, op_hook
from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
from multimodal_context_reasoning_torch.train import step
from multimodal_context_reasoning_torch.train.graphs import CudaGraphs, SegmentedGraphs
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.utils.profiling import counter

KINDS = ("eager", "captures", "replays")


class FakeGraphs:
    """The CUDA graph calls of ``CudaGraphs`` as a log, on the CPU.  A
    fake segment records nothing and replays nothing, and a borrowed
    tensor is the tensor itself."""

    device_type = "cpu"

    def __init__(self, fail_at=None):
        self.log, self.fail_at, self.begun = [], fail_at, 0

    def pool(self):
        return "pool"

    def graph(self):
        return object()

    def begin(self, graph, pool):
        self.begun += 1
        if self.begun == self.fail_at:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.log.append("begin")

    def end(self, graph):
        self.log.append("end")

    def replay(self, graph):
        self.log.append("replay")

    @staticmethod
    def side_stream(device):
        return contextlib.nullcontext()

    @staticmethod
    def borrow(t):
        return t


def graph_counts():
    return {k: counter(f"step.graph.{k}") for k in KINDS}


def delta(fn, *names):
    """``fn()``'s result and how far each counter of ``names`` moved."""
    before = [counter(n) for n in names]
    out = fn()
    return out, {n: counter(n) - b for n, b in zip(names, before)}


def call_kind(fn):
    """``fn()``'s result and which of eager / capture / replay it was."""
    before = graph_counts()
    out = fn()
    moved = [k for k, v in graph_counts().items() if v != before[k]]
    assert len(moved) == 1, moved
    return out, moved[0]


def eager(model, batch):
    model.eval()
    with torch.inference_mode():
        return step._eval_forward(model, batch)


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- the CPU

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model: one intra-op thread keeps it off the cores the other
    test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    cfg = ModCRConfig.tiny()
    ds = synthetic_dataset(np.random.default_rng(0), 12, cfg)

    def batch(i, questions=2):
        rows = range(questions * i, questions * (i + 1))
        return {k: torch.from_numpy(v) for k, v in ds.batch(list(rows)).items()}

    def model(seed=0):
        return ModCRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))

    return model, batch


@pytest.fixture
def fake(monkeypatch):
    backend = FakeGraphs()
    graphs = SegmentedGraphs(step._eval_forward, backend)
    monkeypatch.setattr(step, "EVAL_GRAPHS", graphs)
    return backend, graphs


def test_first_call_eager_second_captures_third_replays(tiny, fake):
    backend, graphs = fake
    make_model, batch = tiny
    model = make_model()
    kinds, outs = [], []
    for i in range(4):
        if i == 1:
            del backend.log[:]
        if i == 2:
            captured = list(backend.log)
            del backend.log[:]
        out, kind = call_kind(lambda: step.eval_step(model, batch(i)))
        kinds.append(kind)
        outs.append(out)
    assert kinds == ["eager", "captures", "replays", "replays"]
    g = graphs.graph(model)
    assert len(g.segments) == len(g.ops) + 1 > 1
    # the capture ends and runs each segment before the op that cuts it
    assert captured == ["begin", "end", "replay"] * len(g.segments)
    assert backend.log == ["replay"] * len(g.segments) * 2
    # the eager call and the capture (which runs each segment as it goes)
    # give the eager forward's numbers
    for i in range(2):
        assert_same(outs[i], eager(model, batch(i)))


def test_capture_cuts_at_every_call_op_and_records_its_arguments(tiny, fake):
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    seen = []

    def spy(op, diff_inputs, args):
        seen.append((op, args))
        with op_hook(None):
            return call_op(op, diff_inputs, *args)

    with op_hook(spy):
        eager(model, batch(0))
    step.eval_step(model, batch(0))
    step.eval_step(model, batch(1))
    g = graphs.graph(model)
    assert seen and len(g.ops) == len(seen)

    def form(a):
        return (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a

    for (op, args, out), (want_op, want_args) in zip(g.ops, seen):
        assert op is want_op
        assert [form(a) for a in args] == [form(a) for a in want_args]
        assert form(out) == form(want_args[0])      # shaped like q


@pytest.mark.parametrize("change, then", [
    ("geometry", ["eager", "captures", "replays"]),
    ("replaced_parameter", ["eager", "captures", "replays"]),
    ("in_place_update", ["replays", "replays", "replays"]),
])
def test_what_captures_again(tiny, fake, change, then):
    make_model, batch = tiny
    model = make_model()
    for i in range(2):
        step.eval_step(model, batch(i))
    questions = 3 if change == "geometry" else 2
    if change == "replaced_parameter":
        w = model.abst_confidence_scorer.weight
        model.abst_confidence_scorer.weight = torch.nn.Parameter(w.detach().clone())
    if change == "in_place_update":
        with torch.no_grad():
            model.abst_confidence_scorer.weight.add_(0.5)
    assert [call_kind(lambda: step.eval_step(model, batch(i, questions)))[1]
            for i in range(3)] == then


@pytest.mark.parametrize("case", ["cpu", "tp_mesh", "off_device", "not_a_tensor"])
def test_what_stays_eager(tiny, case):
    make_model, batch = tiny
    model = make_model()
    if case == "cpu":
        # the CUDA backend with the model on the CPU: eval_step as it is
        graphs = step.EVAL_GRAPHS
        run = lambda i: step.eval_step(model, batch(i))
    else:
        calls = []
        graphs = SegmentedGraphs(lambda m, b: calls.append(1) or {"x": torch.ones(1)},
                                 FakeGraphs())
        b = batch(0)
        if case == "tp_mesh":
            model.tp_mesh = "mesh"
        if case == "off_device":
            b["img_feat"] = torch.empty(b["img_feat"].shape, device="meta")
        if case == "not_a_tensor":
            b["img_feat"] = b["img_feat"].numpy()
        run = lambda i: graphs(model, b)
    assert [call_kind(lambda: run(i))[1] for i in range(3)] == ["eager"] * 3
    assert graphs.graph(model) is None
    assert case == "cpu" or len(calls) == 3


def test_a_failed_capture_leaves_the_key_eager(tiny, monkeypatch):
    make_model, batch = tiny
    model = make_model()
    graphs = SegmentedGraphs(step._eval_forward, FakeGraphs(fail_at=3))
    monkeypatch.setattr(step, "EVAL_GRAPHS", graphs)
    step.eval_step(model, batch(0))
    with pytest.warns(UserWarning, match="capture failed"):
        out, kind = call_kind(lambda: step.eval_step(model, batch(1)))
    assert kind == "captures"
    assert_same(out, eager(model, batch(1)))
    assert graphs.graph(model).failed and not graphs.graph(model).segments
    assert call_kind(lambda: step.eval_step(model, batch(2)))[1] == "eager"


def test_replays_return_distinct_tensors(tiny, fake):
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    outs = [step.eval_step(model, batch(i)) for i in range(4)]
    statics = graphs.graph(model).outputs
    for k in outs[0]:
        ptrs = {o[k].data_ptr() for o in outs[2:]} | {statics[k].data_ptr()}
        assert len(ptrs) == 3, k
    keep = outs[3]["logits"].clone()
    with torch.inference_mode():     # the eager path's outputs are inference tensors too
        outs[2]["logits"].add_(1.0)
    assert torch.equal(outs[3]["logits"], keep)


def test_counts_inside_segments_come_back_on_every_replay(tiny, fake):
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    names = ("attention.plain.probs", "attention.plain.dropout")
    moved = [delta(lambda: step.eval_step(model, batch(i)), *names)[1] for i in range(4)]
    assert moved[0]["attention.plain.probs"] > 0
    assert all(m == moved[0] for m in moved)
    # counted at the capture, less the op calls' own counts
    assert graphs.graph(model).counts == {"attention.plain.probs":
                                          moved[0]["attention.plain.probs"]}


def test_inputs_copied_unless_already_at_their_address(tiny, fake):
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    # img_feat passed as one tensor to the eager call and the capture: a
    # table, read where it is; every other tensor is the graph's own copy
    table = batch(0)["img_feat"].clone()
    keep = table.clone()
    for i in range(2):
        step.eval_step(model, dict(batch(i), img_feat=table))
    g = graphs.graph(model)
    assert set(g.tables) == {"img_feat"}
    assert g.inputs["img_feat"] is table
    fresh = dict(batch(2), img_feat=table)
    sent = {k: v.clone() for k, v in fresh.items()}
    assert call_kind(lambda: step.eval_step(model, fresh))[1] == "replays"
    assert_same(g.inputs, fresh)
    assert_same(fresh, sent)            # the caller's tensors are only read
    for name, t in g.inputs.items():
        if name != "img_feat":
            assert t.untyped_storage().data_ptr() != fresh[name].untyped_storage().data_ptr()
    # another table of the same shape is a new key: eager once, then a
    # capture that reads the new table, and the first is never written
    other = table + 1.0
    kinds = [call_kind(lambda: step.eval_step(model, dict(batch(i), img_feat=other)))[1]
             for i in range(3)]
    assert kinds == ["eager", "captures", "replays"]
    assert graphs.graph(model).inputs["img_feat"] is other
    assert torch.equal(table, keep)


def test_replays_never_write_the_callers_batches(tiny, fake):
    """Batches b0, b1, b2, then b1 again, all kept by the caller: each is
    copied into the graph's inputs and left as it was."""
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    batches = [batch(i) for i in range(3)]
    sent = [{k: v.clone() for k, v in b.items()} for b in batches]
    kinds = [call_kind(lambda: step.eval_step(model, batches[i]))[1] for i in (0, 1, 2, 1)]
    assert kinds == ["eager", "captures", "replays", "replays"]
    for b, want in zip(batches, sent):
        assert_same(b, want)
    g = graphs.graph(model)
    assert g.tables == {}
    assert_same(g.inputs, sent[1])
    mine = {t.untyped_storage().data_ptr() for t in g.inputs.values()}
    assert not mine & {t.untyped_storage().data_ptr() for b in batches for t in b.values()}


@pytest.mark.parametrize("sizes, kinds", [
    # an evaluation's short last batch, then the next evaluation
    ([2, 2, 2, 1, 2, 2], ["eager", "captures", "replays", "eager", "replays", "replays"]),
    # a new key twice in a row replaces the graph
    ([2, 2, 1, 1, 1, 2], ["eager", "captures", "eager", "captures", "replays", "eager"]),
    # alternating keys keep the first graph
    ([2, 2, 1, 2, 1, 2], ["eager", "captures", "eager", "replays", "eager", "replays"]),
])
def test_a_key_seen_once_keeps_the_graph(tiny, fake, sizes, kinds):
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    graph = []
    got = []
    for i, q in enumerate(sizes):
        got.append(call_kind(lambda: step.eval_step(model, batch(i % 4, q)))[1])
        graph.append(graphs.graph(model))
    assert got == kinds
    # a graph is replaced only by a capture
    for i in range(1, len(sizes)):
        assert (graph[i] is graph[i - 1]) == (kinds[i] != "captures")


def test_an_exception_in_the_capture_ends_it_and_leaves_the_key_eager(tiny, monkeypatch):
    make_model, batch = tiny
    model = make_model()
    backend = FakeGraphs()
    calls = []

    def fn(m, b):
        calls.append(1)
        out = step._eval_forward(m, b)
        if len(calls) == 2:
            raise ValueError("not a capture error")
        return out

    graphs = SegmentedGraphs(fn, backend)
    monkeypatch.setattr(step, "EVAL_GRAPHS", graphs)
    step.eval_step(model, batch(0))
    with pytest.raises(ValueError, match="not a capture error"):
        step.eval_step(model, batch(1))
    g = graphs.graph(model)
    assert g.failed and not g.segments and not g.ops and not g.inputs
    # the open segment was ended: as many ends as begins
    assert backend.log.count("begin") == backend.log.count("end") > 0
    out, kind = call_kind(lambda: step.eval_step(model, batch(2)))
    assert kind == "eager"
    assert_same(out, eager(model, batch(2)))


def test_graph_freed_with_the_model(tiny, fake):
    _, graphs = fake
    make_model, batch = tiny
    model = make_model()
    for i in range(3):
        step.eval_step(model, batch(i))
    assert graphs.graph(model) is not None
    del model
    gc.collect()
    assert len(graphs._graphs) == 0


def test_eval_step_puts_every_module_in_eval_mode(tiny):
    make_model, batch = tiny
    model = make_model()
    for train in (model, model.roberta):
        train.train()
        step.eval_step(model, batch(0))
        assert not any(m.training for m in model.modules())


def test_borrow_aliases_without_owning():
    t = torch.arange(12.0).view(3, 4)[1:]
    v = CudaGraphs.borrow(t)
    assert v.shape == t.shape and v.stride() == t.stride() and v.data_ptr() == t.data_ptr()
    t.mul_(2.0)
    assert torch.equal(v, t)
    ref = torch.multiprocessing.reductions.StorageWeakRef(t.untyped_storage())
    del t
    gc.collect()
    assert ref.expired()


# ---------------------------------------------------------------- the card

SEED = 2147490011
QUESTIONS = 32            # pmr_eval_b32's batch: 128 rows


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    cfg = ModCRConfig().with_dtype("bfloat16")
    ds = synthetic_dataset(np.random.default_rng(SEED), 6 * QUESTIONS, cfg)

    def model(dtype="bfloat16"):
        return ModCRModel(ModCRConfig().with_dtype(dtype), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(SEED))

    def batch(i):
        host = ds.batch(list(range(QUESTIONS * i, QUESTIONS * (i + 1))))
        return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v).to("cuda")
                for k, v in host.items()}

    return model, batch, ds, cfg


@pytest.fixture
def card(card_model, monkeypatch):
    graphs = SegmentedGraphs(step._eval_forward)
    monkeypatch.setattr(step, "EVAL_GRAPHS", graphs)
    return card_model + (graphs,)


LAUNCHES = ("ops.spec_attention.launches", "attention.plain.probs")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_card_replays_bit_equal_to_eager(card, dtype):
    make_model, batch, _, _, graphs = card
    model = make_model(dtype)
    kinds = []
    for i in range(5):
        b = batch(i)
        want = eager(model, b)
        got, kind = call_kind(lambda: step.eval_step(model, b))
        kinds.append(kind)
        assert_same(got, want)
    assert kinds == ["eager", "captures", "replays", "replays", "replays"]
    assert len(graphs.graph(model).ops) == 57


@pytest.mark.cuda
def test_card_batches_passed_again_and_a_short_batch(card):
    """Batches kept on the card and passed as b0, b1, b2, b1, then a short
    last batch and b0: every result the eager forward's, and the caller's
    batches untouched."""
    make_model, batch, ds, _, graphs = card
    model = make_model()
    batches = [batch(i) for i in range(3)]
    short = {k: torch.from_numpy(v).to("cuda")
             for k, v in ds.batch(list(range(3 * QUESTIONS, 3 * QUESTIONS + 20))).items()}
    sent = [{k: v.clone() for k, v in b.items()} for b in batches]
    order = [batches[i] for i in (0, 1, 2, 1)] + [short, batches[0]]
    want = [eager(model, b) for b in order]
    kinds = []
    for b, w in zip(order, want):
        got, kind = call_kind(lambda: step.eval_step(model, b))
        kinds.append(kind)
        assert_same(got, w)
    assert kinds == ["eager", "captures", "replays", "replays", "eager", "replays"]
    for b, w in zip(batches, sent):
        assert_same(b, w)


@pytest.mark.cuda
def test_card_replay_counts_what_eager_counts(card):
    make_model, batch, _, _, _ = card
    model = make_model()
    moved = [delta(lambda: step.eval_step(model, batch(i)), *LAUNCHES)[1] for i in range(4)]
    torch.cuda.synchronize()
    assert moved == [{LAUNCHES[0]: 57, LAUNCHES[1]: 3}] * 4


@pytest.mark.cuda
def test_card_replay_follows_an_in_place_adamw_step(card):
    make_model, batch, _, _, _ = card
    model = make_model()
    for i in range(2):
        step.eval_step(model, batch(i))
    before = step.eval_step(model, batch(2))
    state = TrainState.create(model, TrainConfig(learning_rate=1e-3), 10)
    step.train_step(state, batch(3))
    b = batch(2)
    want = eager(model, b)
    got, kind = call_kind(lambda: step.eval_step(model, b))
    assert kind == "replays"
    assert_same(got, want)
    assert not torch.equal(got["logits"], before["logits"])


@pytest.mark.cuda
def test_card_device_table_is_not_copied(card):
    make_model, _, ds, cfg, graphs = card
    model = make_model()
    table = DeviceFeatureTable.for_config(ds.image_features, cfg, device="cuda")
    ds.use_device_table(table)
    try:
        def batch(i):
            host = ds.batch(list(range(QUESTIONS * i, QUESTIONS * (i + 1))))
            return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v).to("cuda")
                    for k, v in host.items()}

        for i in range(3):
            b = batch(i)
            want = eager(model, b)
            assert_same(step.eval_step(model, b), want)
    finally:
        ds.use_device_table(None)
    tables = set(graphs.graph(model).tables)
    assert tables == {"feat_table", "feat_mask_table"}


@pytest.mark.cuda
def test_card_profiler_sees_each_op_with_its_kernel(card):
    from torch.profiler import ProfilerActivity, profile

    make_model, batch, _, _, _ = card
    model = make_model()
    for i in range(2):
        step.eval_step(model, batch(i))
    b = [batch(i) for i in range(2, 4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for x in b:
            step.eval_step(model, x)
        torch.cuda.synchronize()
    events = prof.events()
    ops = [e for e in events if e.name == "modcr_torch::spec_attention"]
    assert len(ops) == 2 * 57
    assert all(e.device_time_total > 0 and e.input_shapes for e in ops)
    # the replayed products are on the trace too
    kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(n.startswith("nvjet") or "gemm" in n.lower() for n in kernels)
