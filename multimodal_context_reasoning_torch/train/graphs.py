"""Segmented CUDA graphs of a step: the work between the port's kernel ops
recorded once and replayed, the ops themselves called eagerly.

Eager PyTorch enqueues a ModCR forward as thousands of dispatches (products,
casts, norms, mask arithmetic), so the host, not the card, sets the pace of
a scoring batch.  :class:`SegmentedGraphs` wraps a function ``fn(model,
batch) -> {name: tensor}`` (``train/step.py::eval_step``'s forward) and

- runs it eagerly on the first call under a key (the warm-up: library
  loads, cuBLAS handles, the launchers' one-time attributes);
- on the second call in a row under that key, captures it in segments and
  replays them as it goes;
- on every later call under the key, copies the batch into the graph's
  inputs and replays.

The cuts are the port's op chokepoint, ``ops/fused_attention.py::
call_op``: while a capture is open on this thread, each op call ends the
current segment, runs the op through the dispatcher on the segment's own
tensors into the op's static output (allocated in the segment, shaped by
the op's fake implementation) and begins the next segment.  A replay runs
segment, op, ``static_out.copy_(result)``, segment, ...  So every
``modcr_torch`` op still enters the dispatcher with its host-side checks,
its ``launches`` counter and its profiler event, and everything between
them is one graph launch.

The graph engages only where it can: the model's parameters on the
backend's device type (CUDA), no ``tp_mesh`` (its collectives stay eager),
every batch value a tensor on that device.  Anything else runs ``fn``
eagerly.  The key is each batch tensor's name, shape and dtype and the
addresses of the model's parameters and buffers: a new geometry or a
replaced parameter captures again, while an in-place update (the
optimizer's ``_foreach_`` steps, ``load_state_dict``) is read by the next
replay as the eager path would read it.  Python state that changes what
``fn`` launches without changing any of these (a config flag flipped on a
live model) is not seen.

One graph is kept per model and freed with the model (held weakly).  A key
it does not match runs eagerly; only a new key that comes twice in a row
replaces the graph, so one odd batch (an evaluation's short last batch)
costs one eager call and no capture.

Inputs: the capture clones every batch tensor into a tensor the graph owns,
and a replay copies the call's tensors into those; a tensor of the caller's
is never written.  A batch tensor whose storage the eager call before the
capture passed too, at the same address (a device table), is read where it
is and never copied; its address and strides are part of the key, so a
different table captures again rather than being read in the old one's
place.

Memory: every segment shares one private pool, which holds what one eager
forward holds at its peak.  The op arguments and static outputs a replay
needs are kept as views that do not own their storage, so the pool reuses
their blocks as the eager forward's allocator would; a tensor argument
must therefore be a parameter or buffer of the model, a batch tensor or a
tensor made inside ``fn``.  A capture that raises leaves its key eager;
one that fails as a capture (a ``RuntimeError`` or ``TypeError``) runs the
call eagerly with a warning, and any other exception is raised again.

Counters that ``fn`` counts inside a segment while it is captured are
counted again on every replay, so a counter reads per call what the eager
path reads; the op calls count their own.  Spans opened inside ``fn``
(``model.*``) are recorded at the capture and not on replays.
"""

from __future__ import annotations

import contextlib
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from multimodal_context_reasoning_torch.ops.fused_attention import call_op, op_hook
from multimodal_context_reasoning_torch.utils.profiling import count, recording_counts

Batch = Dict[str, torch.Tensor]


class CudaGraphs:
    """The CUDA calls of a capture (a test substitutes a fake)."""

    device_type = "cuda"

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def graph():
        return torch.cuda.CUDAGraph()

    @staticmethod
    def begin(graph, pool) -> None:
        # thread-local: another thread's CUDA calls (a loader's) are not
        # caught by this capture
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")

    @staticmethod
    def end(graph) -> None:
        graph.capture_end()

    @staticmethod
    def replay(graph) -> None:
        graph.replay()

    @staticmethod
    @contextlib.contextmanager
    def side_stream(device: torch.device):
        """A capture's stream: after the caller's queued work, and the
        caller's stream after it."""
        caller = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(caller)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            caller.wait_stream(side)

    @staticmethod
    def borrow(t: torch.Tensor) -> torch.Tensor:
        """A view of ``t``'s memory that does not keep it allocated."""
        s = t.untyped_storage()
        storage = torch._C._construct_storage_from_data_pointer(s.data_ptr(), t.device,
                                                               s.nbytes())
        return t.new_empty(0).set_(storage, t.storage_offset(), t.shape, t.stride())


class _Graph:
    """One model's graph under one key."""

    def __init__(self, key, tables: Dict[str, Tuple[int, tuple]]):
        self.key = key
        # batch tensors read where the caller keeps them (name: address,
        # strides): the same storage in the eager call and the capture
        self.tables = tables
        self.segments: list = []          # the backend's graphs, in order
        # after segment i: (op, args, static output), borrowed; a capture
        # runs under no gradient, so a replay calls the op below autograd
        self.ops: List[Tuple] = []
        self.inputs: Batch = {}           # the graph's own, but the tables
        self.outputs: Batch = {}
        self.counts: Dict[str, int] = {}  # counted inside the segments, per call
        self.failed = False               # the capture raised: eager under this key

    def matches(self, key, batch: Batch) -> bool:
        if key != self.key:
            return False
        for name, (ptr, stride) in self.tables.items():
            t = batch[name]
            if t.data_ptr() != ptr or t.stride() != stride:
                return False
        return True


class _Capture:
    """The open capture: the cut at each op call (``op_hook``)."""

    def __init__(self, backend, graph: _Graph):
        self.b, self.g = backend, graph
        self.pool = backend.pool()
        self.open = None

    def begin(self) -> None:
        self.open = self.b.graph()
        self.b.begin(self.open, self.pool)
        self.g.segments.append(self.open)

    def end(self) -> None:
        """End the open segment and run it."""
        seg, self.open = self.open, None
        self.b.end(seg)
        self.b.replay(seg)

    def cut(self, op, diff_inputs, args):
        # the static output, shaped by the op's fake implementation and
        # allocated before the segment ends, so in the pool
        meta = op(*(torch.empty_like(a, device="meta") if isinstance(a, torch.Tensor) else a
                    for a in args))
        if not isinstance(meta, torch.Tensor):
            raise TypeError(f"{op}: a captured op returns one tensor")
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        out = torch.empty_strided(meta.shape, meta.stride(), dtype=meta.dtype, device=device)
        self.end()
        with op_hook(None), recording_counts(None):
            out.copy_(call_op(op, diff_inputs, *args))
        self.begin()
        borrow = self.b.borrow
        self.g.ops.append((op, tuple(borrow(a) if isinstance(a, torch.Tensor) else a
                                     for a in args), borrow(out)))
        return out

    def abort(self) -> None:
        if self.open is not None:
            with contextlib.suppress(Exception):
                self.b.end(self.open)
            self.open = None


def _addresses(model: torch.nn.Module) -> Tuple[int, ...]:
    """The data addresses of ``model``'s parameters and buffers, in a
    fixed order (a walk of ``_modules``: a third of the host time of
    ``parameters()`` and ``buffers()``, which this runs on every call)."""
    out = []
    add = out.append
    stack = [model]
    while stack:
        m = stack.pop()
        if m is None:
            continue
        for t in m._parameters.values():
            if t is not None:
                add(t.data_ptr())
        for t in m._buffers.values():
            if t is not None:
                add(t.data_ptr())
        stack.extend(m._modules.values())
    return tuple(out)


class SegmentedGraphs:
    """``fn(model, batch)``, captured and replayed in segments per model
    (see the module docstring).  Counts each call as ``step.graph.eager``,
    ``step.graph.captures`` or ``step.graph.replays``."""

    def __init__(self, fn: Callable[[torch.nn.Module, Batch], Batch], backend=CudaGraphs):
        self.fn, self.backend = fn, backend
        self._graphs: "weakref.WeakKeyDictionary[torch.nn.Module, _Graph]" = \
            weakref.WeakKeyDictionary()
        # per model, a key its graph does not match, seen on the last call,
        # with the storages of that call's batch
        self._seen: "weakref.WeakKeyDictionary[torch.nn.Module, tuple]" = \
            weakref.WeakKeyDictionary()

    def graph(self, model: torch.nn.Module) -> Optional[_Graph]:
        return self._graphs.get(model)

    def _key(self, model: torch.nn.Module, batch) -> Optional[tuple]:
        """The key of this call, or None where the graph cannot engage."""
        if getattr(model, "tp_mesh", None) is not None:
            return None
        p = next(model.parameters(), None)
        if p is None or p.device.type != self.backend.device_type:
            return None
        device = p.device
        shapes = []
        for name, t in sorted(batch.items()):
            if not isinstance(t, torch.Tensor) or t.device != device:
                return None
            shapes.append((name, tuple(t.shape), t.dtype))
        return device, tuple(shapes), _addresses(model)

    def __call__(self, model: torch.nn.Module, batch: Batch) -> Batch:
        key = self._key(model, batch)
        if key is not None:
            g = self._graphs.get(model)
            if g is not None and g.matches(key, batch):
                self._seen.pop(model, None)
                if not g.failed:
                    count("step.graph.replays")
                    return self._replay(g, batch)
            else:
                seen = self._seen.pop(model, None)
                if seen is not None and seen[0] == key:
                    # a new key twice in a row: it replaces the graph
                    self._graphs.pop(model, None)
                    g = self._graphs[model] = _Graph(key, _tables(seen[1], batch))
                    count("step.graph.captures")
                    return self._capture(g, model, batch)
                self._seen[model] = key, {name: (StorageWeakRef(t.untyped_storage()),
                                                 t.data_ptr(), t.stride())
                                          for name, t in batch.items()}
        count("step.graph.eager")
        return self.fn(model, batch)

    def _capture(self, g: _Graph, model: torch.nn.Module, batch: Batch) -> Batch:
        # the graph reads its own copy of every batch tensor but the tables,
        # and never writes into a tensor of the caller's
        g.inputs = {name: t if name in g.tables else t.clone() for name, t in batch.items()}
        cap = _Capture(self.backend, g)
        tape: list = []
        failure = None
        with self.backend.side_stream(next(model.parameters()).device), \
                recording_counts(tape), op_hook(cap.cut):
            try:
                cap.begin()
                out = self.fn(model, g.inputs)
                cap.end()
            except BaseException as e:
                cap.abort()
                g.failed, g.segments, g.ops, g.inputs = True, [], [], {}
                if not isinstance(e, (RuntimeError, TypeError)):
                    raise
                # an operation that cannot be captured (ended on the stream
                # that captured it): this key stays eager
                failure = e
        if failure is not None:
            warnings.warn(f"segmented graph capture failed, running eagerly: {failure}")
            return self.fn(model, batch)
        g.outputs = out
        for name, n in tape:
            g.counts[name] = g.counts.get(name, 0) + n
        return {k: v.clone() for k, v in out.items()}

    def _replay(self, g: _Graph, batch: Batch) -> Batch:
        for name, t in batch.items():
            if name not in g.tables:
                g.inputs[name].copy_(t)
        replay = self.backend.replay
        for seg, (op, args, out) in zip(g.segments, g.ops):
            replay(seg)
            out.copy_(call_op(op, (), *args))
        replay(g.segments[-1])
        for name, n in g.counts.items():
            count(name, n)
        return {k: v.clone() for k, v in g.outputs.items()}


def _tables(seen: dict, batch: Batch) -> Dict[str, Tuple[int, tuple]]:
    """The tensors of ``batch`` that the call before it passed too, storage
    and all (a device table): name to address and strides."""
    out = {}
    for name, t in batch.items():
        ref, ptr, stride = seen[name]
        if (not ref.expired() and ref == StorageWeakRef(t.untyped_storage())
                and t.data_ptr() == ptr and t.stride() == stride):
            out[name] = ptr, stride
    return out
