"""InferenceModel: thread-safe serving model, and the DynamicBatcher.

- One model serves any number of threads: the forward mutates nothing, so
  concurrency policy is *batching* policy (``DynamicBatcher``).
- Shape buckets: requests pad up to the next bucket, and larger batches
  split into full-bucket chunks (``plan_buckets``), so the set of batch
  shapes the device sees stays bounded.
- One program per bucket signature, the JAX package's one executable per
  signature: on the card, the bucket's forward over static input buffers
  runs eagerly for the signature's first request and is then captured
  into a CUDA graph (``core/graphs.py``), each later request's batch
  copied in and the graph replayed.  A graph's buffers take a lock
  of their own; a capture takes the model's gate exclusively, so no
  replay of this model runs beside it.  ``compile_count`` counts the
  signatures captured live.  ``attach_compile_cache`` persists every
  captured signature (``deploy/compile_cache.py``), and ``warm()``
  captures all of them before the first request, so a restarted server
  holds ``compile_count == 0``.  On the CPU the same static-buffer
  program runs eagerly.
- Replicas: ``replica_forwards`` gives the serving ``DeviceExecutor``
  per-device ``ModelReplica`` objects with an asynchronous dispatch.  A
  dispatch fills the bucket program's static inputs from its pinned
  staging buffer, replays the graph, and enqueues the copy of the
  outputs (the fused top-N's (indices, values) when ``top_n`` is set)
  into pinned host buffers owned by that flight, then records an event;
  ``harvest`` waits on that event only.  So a later replay of the same
  bucket never overwrites answers not yet read, and no harvest
  synchronises the card.
- One serving stream per device: every program's copies, eager runs and
  replays, of every model, go on it in the order they are launched, each
  launch after the work the caller's stream holds so far (the writes of
  its inputs and of the weights a rebuild or ``fit`` left there).
  Graphs captured by one thread share the library workspaces of the
  stream they were captured on (cuBLAS keys its workspace by handle and
  stream), so two replays must never run at once; on one stream they
  cannot.  Serving graphs are captured on a capture stream of their own,
  never on PyTorch's default capture stream, where ``fit`` captures its
  step programs: training and serving in one process replay on
  different streams and so must not share a workspace.  No replay or
  copy lands on a stream being captured.
- int8 / int4 weights: per-output-channel symmetric quantization, with
  the JAX package's rule and leaf format (``quantize_pytree``).  Dense
  kernels stay packed end to end and run through the fused
  dequantize-matmul kernel; every other quantized leaf (the embedding
  tables) is stored quantized and dequantized in the forward
  (``nn.module.Layer.leaf``).  That is the JAX package's
  ``_dequant_for_forward`` rule; it needs no tree transform here, and no
  ``_dense_layer_names``, because each layer owns its leaves and reads
  them in the form it can use.  Layer state (BatchNormalization's moving
  statistics) is never quantized; every bucket program runs the net in
  eval mode, so it normalizes with them.
- bf16 inference: a ``preprocess`` that emits bf16 (``imagenet_preprocess``,
  uint8 wire images normalized on the card) selects it, as the JAX
  package's ``_match_compute_dtype`` does: inside the bucket program the
  float parameters and state are cast to the input's dtype (the buffers
  of quantized leaves stay as stored) and the outputs come back as f32.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import struct
import threading
import time
import zlib
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from analytics_zoo_tpu_torch.core import graphs
from analytics_zoo_tpu_torch.core.context import resolve_device
from analytics_zoo_tpu_torch.nn.module import cast_floats, is_qleaf, prune

__all__ = ["InferenceModel", "DynamicBatcher", "BatchRequest",
           "ModelReplica", "scatter_batch_results", "quantize_pytree",
           "dequantize_pytree", "plan_buckets", "bucket_class",
           "imagenet_preprocess", "LONG_DOC_TOKENS", "DEFAULT_MODEL"]

# the implicit model name for single-model serving paths; multi-model
# callers (ClusterServing with a dict of models) use their own names
DEFAULT_MODEL = "default"
WEIGHT_DTYPES = ("float32", "int8", "int4")


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def imagenet_preprocess(scale: float = 1.0 / 127.5, offset: float = -1.0,
                        dtype=torch.bfloat16) -> Callable:
    """On-device normalizer for the uint8 image wire format: clients send
    raw uint8 HWC images (a quarter of float32's bytes over the link),
    and the bucket program casts them to ``dtype`` and applies ``x *
    scale + offset`` (default [0, 255] to [-1, 1]), in that dtype.  A bf16
    result selects bf16 inference.  ``scale`` and ``offset`` are rounded
    to ``dtype`` first, as the JAX package's weakly typed constants are,
    so the two give the same bits."""
    scale = float(torch.tensor(scale, dtype=dtype))
    offset = float(torch.tensor(offset, dtype=dtype))

    def fn(x):
        return x.to(dtype) * scale + offset

    return fn


def _net_forward(net, xs):
    """``net`` on the preprocessed inputs at their float dtype: when that
    is a 16-bit float, over copies of the float parameters and state cast
    to it (the JAX package's ``_match_compute_dtype``), unless the net
    says it takes its weights as they are (``casts_weights = False``)."""
    floats = [x.dtype for x in xs if x.is_floating_point()]
    cd = floats[0] if floats else torch.float32
    for d in floats[1:]:
        cd = torch.promote_types(cd, d)
    if (cd not in (torch.bfloat16, torch.float16)
            or not getattr(net, "casts_weights", True)):
        return net(*xs)
    return torch.func.functional_call(net, cast_floats(net, cd), xs)


class _FunctionNet(torch.nn.Module):
    """A torch function of the inputs as the net of a model's bucket
    programs (``InferenceModel.from_function``).  It runs on the inputs
    as they come, bf16 included (no cast of its weights).  When ``fn`` is
    a module, its weights are its ``state_dict``; ``identity`` names the
    function in the model's fingerprint, so two functions never share a
    compile cache's signatures."""

    casts_weights = False

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn
        code = getattr(fn, "__code__", None)
        self.identity = ":".join((
            getattr(fn, "__module__", None) or "",
            getattr(fn, "__qualname__", type(fn).__qualname__),
            hashlib.sha256(code.co_code).hexdigest()[:16] if code else ""))

    def forward(self, *xs):
        return self.fn(*xs)

    def params(self) -> Dict[str, torch.Tensor]:
        return (dict(self.fn.state_dict())
                if isinstance(self.fn, torch.nn.Module) else {})

    def state(self) -> Dict[str, torch.Tensor]:
        return {}


def _device_tensor(x, device: torch.device) -> torch.Tensor:
    """One numpy input (the codec's ``BFLOAT16`` included) as a tensor on
    ``device``."""
    from analytics_zoo_tpu_torch.deploy.codec import BFLOAT16, bf16_to_torch

    x = np.asarray(x)
    t = (bf16_to_torch(x) if x.dtype == BFLOAT16
         else torch.from_numpy(np.ascontiguousarray(x)))
    return t.to(device)


def _eager_forward(fn: Callable, device: torch.device) -> Callable:
    """``forward`` of a function model that calls ``fn`` eagerly on the
    device for every padded batch: numpy in, numpy out."""
    def forward(inputs: List[np.ndarray]):
        with torch.inference_mode():
            out = fn(*[_device_tensor(x, device) for x in inputs])
        if isinstance(out, (list, tuple)):
            return [_host_view(o.detach().cpu().contiguous()) for o in out]
        return _host_view(out.detach().cpu().contiguous())

    return forward


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# Requests at or past this many tokens belong to the "long_doc" bucket
# class: they plan at the smallest row bucket, one program per class
# instead of one per (rows x length) combination.  (The JAX package
# routes that class to mesh replicas, which the port does not have yet.)
LONG_DOC_TOKENS = 32768


def bucket_class(tokens: Optional[int]) -> str:
    """Which bucket class a request of ``tokens`` sequence length falls
    in: ``"long_doc"`` (>= LONG_DOC_TOKENS) or ``"short"``."""
    return ("long_doc" if tokens is not None
            and int(tokens) >= LONG_DOC_TOKENS else "short")


def plan_buckets(n: int, buckets: Sequence[int],
                 tokens: Optional[int] = None) -> List[tuple]:
    """Split ``n`` rows into ``[(rows, bucket), ...]`` chunks: full
    ``buckets[-1]``-row chunks first, then one tail chunk padded up to its
    nearest bucket.  Both ``InferenceModel.predict`` and the serving
    executor's replica dispatch plan through it.  In the ``"long_doc"``
    class (``tokens`` >= LONG_DOC_TOKENS) every chunk is the smallest row
    bucket."""
    if bucket_class(tokens) == "long_doc":
        cap = buckets[0]
        return [(min(n - s, cap), cap) for s in range(0, n, cap)]
    out: List[tuple] = []
    cap = buckets[-1]
    s = 0
    while s < n:
        m = min(n - s, cap)
        out.append((m, _next_bucket(m, buckets)))
        s += m
    return out


def _torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype of a signature's dtype name (``bfloat16`` is the
    codec's wire name)."""
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def _dtype_name(x) -> str:
    from analytics_zoo_tpu_torch.deploy.codec import wire_name

    return wire_name(np.asarray(x).dtype)


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a host tensor (bf16 as the codec's ``BFLOAT16``)."""
    if t.dtype == torch.bfloat16:
        from analytics_zoo_tpu_torch.deploy.codec import BFLOAT16

        return t.view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict) and not is_qleaf(tree):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# weight quantization (the JAX package's rule, bit-identical)
# ---------------------------------------------------------------------------

def quantize_pytree(params, min_size: int = 1024, bits: int = 8):
    """Per-channel symmetric quantization of float leaves.

    ``bits=8``: each quantized leaf becomes ``{"q": int8, "scale": f32
    per-last-axis-channel}``.  ``bits=4``: 2-D leaves with an even row
    count become ``{"q4": nibble-packed int8, "scale": f32}``; other
    leaves keep the int8 scheme.  Leaves with fewer than ``min_size``
    elements, 0-d or non-float leaves pass through unchanged.  Leaves may
    be numpy arrays or tensors; quantized ones come back as CPU tensors.
    """
    from analytics_zoo_tpu_torch.ops.dequant_matmul import quantize_weights
    from analytics_zoo_tpu_torch.ops.quantization import quantize_tensor

    def one(leaf):
        a = torch.as_tensor(np.asarray(leaf.detach().cpu())
                            if isinstance(leaf, torch.Tensor) else
                            np.asarray(leaf))
        if not a.is_floating_point() or a.numel() < min_size or a.ndim == 0:
            return leaf
        if bits == 4 and a.ndim == 2 and a.shape[0] % 2 == 0:
            q4, scale = quantize_weights(a, bits=4)
            return {"q4": q4, "scale": scale.to(torch.float32)}
        if a.ndim >= 2:
            q, scale = quantize_tensor(a, axis=-1)
        else:
            # the JAX package computes this scale in numpy, then casts
            amax = np.max(np.abs(a.numpy()))
            scale = torch.as_tensor(
                np.asarray([amax / 127.0 if amax > 0 else 1.0], np.float32))
            q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale.to(torch.float32)}

    return _tree_map(one, params)


def dequantize_pytree(qparams):
    """Inverse of quantize_pytree: every quantized leaf back to f32."""
    from analytics_zoo_tpu_torch.ops.dequant_matmul import dequantize_leaf

    return _tree_map(lambda x: dequantize_leaf(x) if is_qleaf(x) else x,
                     qparams)


# ---------------------------------------------------------------------------
# one program per bucket signature
# ---------------------------------------------------------------------------

class _Gate:
    """Many replays at once, or one capture alone."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._alone = False

    @contextlib.contextmanager
    def shared(self) -> Iterator[None]:
        with self._cv:
            while self._alone:
                self._cv.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cv:
                self._shared -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def alone(self) -> Iterator[None]:
        with self._cv:
            while self._alone or self._shared:
                self._cv.wait()
            self._alone = True
        try:
            yield
        finally:
            with self._cv:
                self._alone = False
                self._cv.notify_all()


class _Flight:
    """One launch of a bucket program: its outputs, copied into pinned
    host buffers owned by this flight, and the event recorded after the
    copy out.  ``result`` waits on that event alone.  A flight whose
    reader gave up (the executor's harvest watchdog) keeps its buffers
    and event until it is dropped, so the card's late copy lands in
    memory nobody reuses."""

    __slots__ = ("host", "event", "multi", "program", "replayed")

    def __init__(self, host, event, multi, program, replayed=False):
        self.host = host
        self.event = event
        self.multi = multi
        self.program = program      # keeps the graph's memory alive
        self.replayed = replayed

    def result(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [_host_view(h) for h in self.host]

    def device_s(self) -> Optional[float]:
        """Seconds the card ran this flight's program, once ``result``
        has returned: a replay's time, read from the events the graph
        itself records at its start and end (``replay_s``); None for the
        eager warm-up and on the CPU."""
        return self.program.replay_s() if self.replayed else None


class _BucketProgram:
    """The forward of one bucket signature over static input buffers: on
    the card its first run is eager (the warm-up), then it is captured
    into a CUDA graph and replayed; on the CPU, or while graphs are off,
    the same code runs eagerly.  ``launch`` never captures: the model
    captures through ``capture`` alone (``InferenceModel._capture``), and
    hands the one eager warm-up to one caller (``warm_up_taken``).

    Every launch goes on the device's serving stream, after the work the
    caller's stream holds, so the fills of its static inputs, its replays
    and the copies of its static outputs are ordered among themselves,
    and after every other program's, whoever launches.  ``preprocess`` (a
    torch function of the raw inputs, giving the net's inputs) runs
    inside the program; ``top_n`` > 0 ends it with the top-N (int32
    indices, values) of the first output."""

    def __init__(self, net, sig: Dict[str, Any], device: torch.device,
                 name: str, preprocess: Optional[Callable] = None):
        self.device = device
        self.lock = threading.Lock()
        self.warm_up_taken = False
        self.multi = False
        self.inputs = inputs = [
            torch.zeros(shape, dtype=_torch_dtype(dtype), device=device)
            for shape, dtype in sig["in"]]
        cuda = device.type == "cuda"
        self.staging = ([torch.empty_like(t, device="cpu").pin_memory()
                         for t in inputs] if cuda else None)
        self.stream, self.capture_stream = (
            (graphs.private_stream(device, "serving"),
             graphs.private_stream(device, "serving_capture")) if cuda
            else (None, None))
        self._staged: Optional[torch.cuda.Event] = None
        # recorded by the graph at its start and end at every replay
        self.timing = ((torch.cuda.Event(enable_timing=True, external=True),
                        torch.cuda.Event(enable_timing=True, external=True))
                       if cuda else None)
        self._replay_s: Optional[float] = None
        # held around a replay's launch and the reads of ``timing``, never
        # across a wait, so a harvest never waits on a launch
        self._timing_lock = threading.Lock()
        top_n = int(sig.get("top_n") or 0)
        timing = self.timing

        def forward():          # holds the buffers, not the program
            mark = (timing is not None
                    and torch.cuda.is_current_stream_capturing())
            if mark:
                timing[0].record()
            with torch.inference_mode():
                xs = inputs
                if preprocess is not None:
                    xs = _as_tuple(preprocess(*xs))
                out = _net_forward(net, xs)
                multi = isinstance(out, (list, tuple))
                outs = [o.float() if o.is_floating_point() else o
                        for o in (out if multi else [out])]
                if top_n:
                    vals, idx = torch.topk(outs[0], top_n, dim=-1)
                    outs, multi = [idx.to(torch.int32), vals], True
            if mark:
                timing[1].record()
            return outs if multi else outs[0]

        self.graph = graphs.StepGraph(forward, device,
                                      name=f"{name} forward {sig['in']}")

    def capture(self) -> None:
        if not self.graph.captured and graphs.enabled(self.device):
            self.graph.capture(stream=self.capture_stream)
            from analytics_zoo_tpu_torch.observe import metrics as obs

            obs.count("graph_captures_total", kind="serving")
            obs.observe("graph_capture_seconds", self.graph.capture_s,
                        kind="serving")

    def _forward(self):
        g = self.graph
        if not graphs.enabled(self.device):
            out = g.fn()
        elif g.captured:
            with self._timing_lock:
                out = g.replay()
        else:               # the caller that took the warm-up
            out = g.warm_up(self.stream)
        self.multi = isinstance(out, (list, tuple))
        return list(out) if self.multi else [out]

    def replay_s(self) -> Optional[float]:
        """Seconds of this program's latest finished replay on the card,
        between the events the graph records at its start and end (no
        host time lies between them).  Replays of one signature take the
        same kernels over the same shapes, so a flight whose own replay
        was followed by another of the same program before it was read
        is given that one's time.  The first read waits for the latest
        replay; None while no replay has been read."""
        begin, end = self.timing
        if self._replay_s is None:
            end.synchronize()
        with self._timing_lock:     # no replay is launched between reads
            if end.query():
                self._replay_s = begin.elapsed_time(end) / 1e3
        return self._replay_s

    def launch(self, xs: List[np.ndarray]) -> _Flight:
        """Fill the inputs with ``xs`` (one copy each, into the pinned
        staging buffer), run the program and start the copy of its
        outputs to the host; returns the flight without waiting."""
        with self.lock:
            if self.stream is None:
                for t, x in zip(self.inputs, xs):
                    _host_view(t)[...] = x
                outs = self._forward()
                # eager outputs are this call's own; copy them anyway so
                # no later launch can reach them through a view
                return _Flight([o.clone() for o in outs], None,
                               self.multi, self)
            if self._staged is not None:
                # the previous launch's copy out of staging must be done
                # before staging is refilled
                self._staged.synchronize()
            for h, x in zip(self.staging, xs):
                _host_view(h)[...] = x
            replayed = self.graph.captured and graphs.enabled(self.device)
            # after what the caller's stream wrote (the inputs' zeros, a
            # rebuilt or trained net's weights)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for t, h in zip(self.inputs, self.staging):
                    t.copy_(h, non_blocking=True)
                self._staged = torch.cuda.Event()
                self._staged.record(self.stream)
                outs = self._forward()
                host = [torch.empty(o.shape, dtype=o.dtype,
                                    pin_memory=True) for o in outs]
                for h, o in zip(host, outs):
                    h.copy_(o, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            return _Flight(host, done, self.multi, self, replayed)

    def run(self, xs: List[np.ndarray]):
        """``launch`` and wait: the outputs as numpy arrays (a list when
        the program has several)."""
        flight = self.launch(xs)
        out = flight.result()
        return out if flight.multi else out[0]


class ModelReplica:
    """One serving replica: ``dispatch(xs)`` enqueues the computation and
    returns a handle at once; ``harvest(handle)`` waits for it and returns
    a list of numpy output arrays.  The split is what lets the device
    executor double-buffer: dispatch batch N+1 while N's readback is in
    flight."""

    def __init__(self, dispatch: Callable, harvest: Callable, device=None,
                 on_device_topn: bool = False, pads_input: bool = True):
        self.dispatch = dispatch
        self.harvest = harvest
        self.device = device
        self.on_device_topn = on_device_topn
        # False = dispatch() already handles buckets/slicing (the shared
        # predict() fallback); True = the executor pads to a bucket
        self.pads_input = pads_input


# ---------------------------------------------------------------------------
# InferenceModel
# ---------------------------------------------------------------------------

class InferenceModel:
    """Thread-safe model for serving.

        m = InferenceModel.from_keras_net(net, weight_dtype="int8")

    then ``m.predict(inputs)`` from any number of threads.
    """

    def __init__(self, forward: Optional[Callable],
                 batch_buckets: Sequence[int] = (1, 8, 64, 256),
                 dtype=None, name: str = DEFAULT_MODEL):
        """``forward``: fn(list_of_np_inputs_padded) -> np output(s) for a
        full padded batch, wrapped by bucket padding in predict(); None
        for a native net's bucket programs (``from_keras_net``).
        ``dtype`` is kept as ``self.dtype``, as in the JAX package (which
        reads it nowhere either); ``name`` labels this model's series in
        every serving metric."""
        self._forward = forward
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.dtype = dtype
        self.name = str(name)
        # batch-signature ledger: one entry per distinct padded batch
        # shape dispatched that paid a live capture — the bounded-shape
        # contract of the buckets.  Signatures captured from the compile
        # cache (warm()) land in _warm_shapes instead.
        self._seen_shapes = set()
        self._warm_shapes = set()
        self._shape_lock = threading.Lock()
        self._net = None
        self._weight_dtype = "float32"
        self.device: Optional[torch.device] = None
        # one program per signature key; the gate orders captures against
        # replays; the persistent cache and the weights' fingerprint
        self._programs: Dict[str, _BucketProgram] = {}
        self._programs_lock = threading.Lock()
        self._gate = _Gate()
        self._cache = None
        self._fingerprint: Optional[str] = None
        self._preprocess: Optional[Callable] = None

    @staticmethod
    def _shape_key(shapes, top_n: int = 0) -> tuple:
        """The ledger key of a batch signature (shapes + dtypes, and the
        fused top-N when there is one)."""
        key = tuple((tuple(s), str(d)) for s, d in shapes)
        return key + ((("top_n", int(top_n)),) if top_n else ())

    def _note_shapes(self, xs, top_n: int = 0) -> None:
        """Record the batch signature about to be dispatched, on first
        sight (a live capture).  Signatures ``warm()`` captured are not
        novel."""
        sig = self._shape_key(((np.shape(x), _dtype_name(x)) for x in xs),
                              top_n)
        with self._shape_lock:
            if sig in self._seen_shapes or sig in self._warm_shapes:
                return
            self._seen_shapes.add(sig)
            live = len(self._seen_shapes)
        from analytics_zoo_tpu_torch.observe import metrics as obs

        obs.count("inference_novel_batch_shapes_total", model=self.name,
                  flat="inference/novel_batch_shape")
        obs.set_gauge("inference_compile_count", live, model=self.name)

    @property
    def compile_count(self) -> int:
        """Number of distinct batch signatures captured live (signatures
        captured by ``warm()`` excluded)."""
        with self._shape_lock:
            return len(self._seen_shapes)

    @property
    def warm_count(self) -> int:
        """Number of signatures ``warm()`` captured from the cache."""
        with self._shape_lock:
            return len(self._warm_shapes)

    # -- programs and the persistent compile cache ------------------------
    def fingerprint(self) -> str:
        """Content hash of this model's weights: net class + weight dtype
        + per-leaf (path, shape, dtype, CRC32 of the bytes).  The compile
        cache keys on it, so a signature captured for one set of weights
        never warms another."""
        if self._fingerprint is not None:
            return self._fingerprint
        h = hashlib.sha256()
        h.update((type(self._net).__name__ if self._net is not None
                  else "<fn>").encode())
        h.update(getattr(self._net, "identity", "").encode())
        h.update(self._weight_dtype.encode())

        def walk(tree, path):
            for key in sorted(tree):
                leaf = tree[key]
                if isinstance(leaf, dict):
                    walk(leaf, path + (key,))
                    continue
                t = leaf.detach().cpu().contiguous()
                h.update("/".join(path + (key,)).encode())
                h.update(str(tuple(t.shape)).encode())
                h.update(str(t.dtype).encode())
                h.update(struct.pack("<I", zlib.crc32(
                    t.reshape(-1).view(torch.uint8).numpy()) & 0xFFFFFFFF))

        if self._net is not None:
            walk(self._net.params(), ())
            walk(prune(self._net.state()), ("__state__",))
        self._fingerprint = h.hexdigest()[:16]
        return self._fingerprint

    def attach_compile_cache(self, cache, name: Optional[str] = None
                             ) -> "InferenceModel":
        """Wire a ``deploy.compile_cache.CompileCache`` into the dispatch
        path: every signature captured live is persisted, and ``warm()``
        on the next process start captures them all up front.  Only a
        model with bucket programs qualifies (``from_keras_net``, or
        ``from_function`` with ``jit=True``): an eager function model has
        no program to capture."""
        if self._net is None:
            raise ValueError(
                "attach_compile_cache needs bucket programs: a native net "
                "(from_keras_net) or from_function(jit=True); an eager "
                "function model has no program to capture")
        self._cache = cache
        if name:
            self.name = str(name)
        return self

    def _sig(self, xs, top_n: int = 0) -> Dict[str, Any]:
        """JSON-able program signature: input shapes/dtypes + device +
        fused top-N + weight dtype.  Joined with ``fingerprint()`` (and
        the devices, added by the cache) it addresses one program."""
        return {"in": [[list(np.shape(x)), _dtype_name(x)] for x in xs],
                "dev": str(self.device),
                "top_n": int(top_n or 0),
                "weight_dtype": self._weight_dtype}

    def _program(self, sig: Dict[str, Any]) -> Tuple[_BucketProgram, bool]:
        """The program of ``sig``, made if there is none (not captured),
        and whether it was made now."""
        key = json.dumps(sig, sort_keys=True)
        with self._programs_lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog, False
            prog = self._programs[key] = _BucketProgram(
                self._net, sig, torch.device(sig["dev"]), self.name,
                preprocess=self._preprocess)
        return prog, True

    def _capture(self, prog: _BucketProgram) -> None:
        """Capture ``prog`` alone: no run of this model beside it."""
        with self._gate.alone():
            prog.capture()

    def _ready(self, xs: List[np.ndarray], top_n: int = 0
               ) -> _BucketProgram:
        """The program a padded batch runs through: a new signature's
        first run is eager (one caller's, whoever comes first), and any
        other caller captures it (alone) before it runs, so no capture
        happens beside another run of this model."""
        sig = self._sig(xs, top_n)
        prog, new = self._program(sig)
        with self._programs_lock:
            warm_up, prog.warm_up_taken = not prog.warm_up_taken, True
        if new and self._cache is not None and self._cache.load(
                self.fingerprint(), sig, model=self.name) is None:
            self._cache.store(self.fingerprint(), sig, model=self.name)
        if (not warm_up and not prog.graph.captured
                and graphs.enabled(prog.device)):
            self._capture(prog)
        return prog

    def _bucket_forward(self, xs: List[np.ndarray]):
        prog = self._ready(xs)
        with self._gate.shared():
            return prog.run(xs)

    def warm(self) -> int:
        """Capture every signature the compile cache holds for this
        model's fingerprint.  A restarted server reaches full bucket
        coverage here instead of after N live captures, and
        ``compile_count`` stays 0 for every warmed signature.  Returns
        the number of programs installed."""
        if self._cache is None:
            return 0
        n = 0
        for sig, _ in self._cache.load_all(self.fingerprint(),
                                           model=self.name):
            if sig.get("dev") != str(self.device):
                continue
            self._capture(self._program(sig)[0])
            with self._shape_lock:
                self._warm_shapes.add(self._shape_key(
                    sig["in"], sig.get("top_n", 0)))
            n += 1
        return n

    def weight_nbytes(self) -> int:
        """Device bytes of the served weights (quantized leaves at their
        stored size)."""
        if self._net is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in list(self._net.parameters())
                   + list(self._net.buffers()))

    @staticmethod
    def _resolve_weight_dtype(weight_dtype: Optional[str],
                              int8: bool) -> str:
        """None defers to the legacy ``int8`` flag, then to the global
        ``serving_weight_dtype`` knob (no context = float32)."""
        if weight_dtype is None:
            if int8:
                return "int8"
            from analytics_zoo_tpu_torch.ops.dispatch import config_knob

            weight_dtype = config_knob("serving_weight_dtype", "float32")
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"serving weight_dtype must be float32|int8|int4, got "
                f"{weight_dtype!r}")
        return weight_dtype

    @classmethod
    def load(cls, path: str, int8: bool = False,
             weight_dtype: Optional[str] = None, device=None,
             **kw) -> "InferenceModel":
        """Serve the model a ``ZooModel.save_model`` directory holds
        (``config.json`` + ``weights.npz``, written by either package),
        on ``device`` (default ``cuda``)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel

        if not os.path.exists(os.path.join(path, "weights.npz")):
            raise FileNotFoundError(f"{path} has no weights.npz")
        zm = ZooModel.load_model(path, device="cpu")    # weights and state
        return cls.from_keras_net(zm.model, int8=int8,
                                  weight_dtype=weight_dtype, device=device,
                                  **kw)

    @classmethod
    def from_keras_net(cls, net, params=None, state=None, int8: bool = False,
                       preprocess: Optional[Callable] = None,
                       weight_dtype: Optional[str] = None, device=None,
                       **kw) -> "InferenceModel":
        """Wrap a built net as a serving model on ``device`` (default
        ``cuda``; raises when there is none).  The JAX signature (the net,
        its params, its state, ``int8``, ``preprocess``, ``weight_dtype``,
        in that order), with the port's ``device`` after it.

        The net is copied, so the caller's stays as it is.  ``params``
        (a JAX-layout tree of numpy arrays or tensors, plain or already
        quantized) replaces its weights by layer and leaf name, and
        ``state`` (the JAX state tree: BatchNormalization's moving
        statistics) its state; the state is never quantized.
        ``weight_dtype``: "float32", "int8" or "int4"; ``None`` resolves
        the legacy ``int8`` flag, then the ``serving_weight_dtype`` knob.
        ``preprocess``: a torch function of the raw inputs giving the
        net's inputs, run on the device inside each bucket program (so a
        client can send one (B, 2) id pair where the net takes two (B, 1)
        inputs, or compact wire dtypes cast on the card; a bf16 result,
        as ``imagenet_preprocess`` gives, selects bf16 inference).
        """
        from analytics_zoo_tpu_torch.convert import load_jax_params

        device = resolve_device(device)
        weight_dtype = cls._resolve_weight_dtype(weight_dtype, int8)
        net = copy.deepcopy(net).cpu()
        if params is not None or state is not None:
            load_jax_params(net, net.params() if params is None else params,
                            state)
        if weight_dtype != "float32":
            load_jax_params(net, quantize_pytree(
                net.params(), bits=4 if weight_dtype == "int4" else 8))
        net = net.to(device).eval()
        m = cls(None, **kw)
        m._net, m._weight_dtype, m.device = net, weight_dtype, device
        m._preprocess = preprocess
        return m

    @classmethod
    def from_function(cls, fn: Callable, jit: bool = True, device=None,
                      **kw) -> "InferenceModel":
        """Serve a torch function of the inputs on ``device`` (default
        ``cuda``; raises when there is none): ``fn`` takes one tensor per
        input, on the device, and returns a tensor or a list of them.
        ``jit=True`` runs it as a native net runs, through the bucket
        programs (one CUDA graph per bucket signature on the card, kept
        and warmed by a compile cache; float outputs come back as f32);
        ``jit=False`` calls it eagerly on the device for every batch.
        The JAX signature, with the port's ``device`` after it."""
        device = resolve_device(device)
        if not jit:
            m = cls(_eager_forward(fn, device), **kw)
        else:
            m = cls(None, **kw)
            m._net = _FunctionNet(fn).to(device).eval()
        m.device = device
        return m

    @classmethod
    def load_torch(cls, model_or_path, device=None,
                   **kw) -> "InferenceModel":
        """Serve a TorchScript file or a ``torch.nn.Module`` (reference
        TorchNet.scala:39) on ``device`` (default ``cuda``).  A module is
        copied, so the caller's stays where it is; the model is moved to
        the device, put in eval mode and called eagerly on each batch
        there, as the JAX package calls it on the host."""
        device = resolve_device(device)
        if isinstance(model_or_path, (str, os.PathLike)):
            model = torch.jit.load(os.fspath(model_or_path),
                                   map_location=device)
        else:
            model = copy.deepcopy(model_or_path).to(device)
        model.eval()
        m = cls.from_function(model, jit=False, device=device, **kw)
        m._torch_model = model
        return m

    @classmethod
    def load_onnx(cls, path: str, int8: bool = False,
                  calibration_inputs=None, device=None,
                  **kw) -> "InferenceModel":
        """Serve an .onnx file (``onnx/loader.py``) on ``device`` (default
        ``cuda``), through the bucket programs as a native net serves.
        ``int8=True`` runs post-training quantization: the Gemm / MatMul
        nodes run int8 x int8 matmuls (``ops/quantization.py``) — with
        ``calibration_inputs`` (input-arg tuples, run through the f32
        graph on ``device``) the activation scales are static, otherwise
        dynamic per batch.  Replaces the reference's OpenVINO int8 path
        (InferenceModel.scala:443).  The JAX signature, with the port's
        ``device`` after it."""
        from analytics_zoo_tpu_torch.onnx import load_onnx
        from analytics_zoo_tpu_torch.tfpark.model import FunctionModel

        device = resolve_device(device)
        program = load_onnx(path)
        if int8:
            from analytics_zoo_tpu_torch.ops.quantization import \
                quantize_program

            program = quantize_program(program, calibration_inputs,
                                       device=device)
        m = cls(None, **kw)
        m._net = FunctionModel(program).to(device).eval()
        m._weight_dtype = "int8" if int8 else "float32"
        m.device = device
        m.onnx_program, m._int8 = program, int8
        return m

    # -- replicas ----------------------------------------------------------
    def replica_forwards(self, n: int = 1, devices=None,
                         top_n: Optional[int] = None
                         ) -> List["ModelReplica"]:
        """``n`` per-device serving replicas with an asynchronous
        dispatch (at most one per device; ``devices`` defaults to the
        model's device).

        A native net's replica runs the bucket programs: ``dispatch``
        launches one padded batch (``_BucketProgram.launch``) and returns
        its flight, ``harvest`` waits on the flight's event.  Every
        replica of the model, a rebuilt one too, shares its programs
        (those ``warm()`` captured): each launch holds its program's lock
        and reads its answers from buffers of its own, so two replicas
        of one program are as safe as two flights of one replica.  A
        native net serves on its own device only: replicas on other
        cards wait for the multi-GPU slice (ROADMAP A9).  ``top_n`` fuses
        ``torch.topk`` into every program: the readback is (int32
        indices, values) per row, not the scores.  A function model's
        ``n`` replicas share ``predict``, which is host work bound to no
        device (the JAX package gives one per device, and its host
        platform has eight)."""
        if devices is None:
            devices = [self.device] * (1 if self._net is not None else n)
        devices = list(devices)[:max(1, int(n))]
        if self._net is None:
            # shared-forward fallback: predict() handles buckets/top-N
            def dispatch(xs, _m=self):
                return _m.predict(xs)

            def harvest(h):
                return h if isinstance(h, list) else [h]

            return [ModelReplica(dispatch, harvest, device=None,
                                 on_device_topn=False, pads_input=False)
                    for _ in devices]
        other = [d for d in devices if torch.device(d) != self.device]
        if other:
            raise NotImplementedError(
                f"{self.name} serves on {self.device}; replicas on "
                f"{other} wait for the multi-GPU slice (ROADMAP A9)")
        top_n = int(top_n or 0)

        def dispatch(xs):
            self._note_shapes(xs, top_n)
            prog = self._ready(xs, top_n)
            with self._gate.shared():
                return prog.launch(xs)

        def harvest(flight):
            out = flight.result()
            dev_s = flight.device_s()
            if dev_s is not None:
                from analytics_zoo_tpu_torch.observe import metrics as obs

                obs.count("serving_device_busy_seconds_total", dev_s,
                          model=self.name)
            return out

        return [ModelReplica(dispatch, harvest, device=self.device,
                             on_device_topn=bool(top_n), pads_input=True)
                for _ in devices]

    def params(self):
        """The served weight tree (quantized leaves as stored)."""
        return self._net.params()

    def predict(self, inputs, batch_size: Optional[int] = None):
        """Predict on one batch (list of arrays or a single array).

        Rows are padded up to the next batch bucket; batches larger than
        the biggest bucket (or than ``batch_size``, snapped down to a
        bucket) run as full-bucket chunks.
        """
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(x) for x in xs]
        n = xs[0].shape[0]
        bucket = _next_bucket(n, self.batch_buckets)
        if batch_size:
            eff = max((b for b in self.batch_buckets if b <= batch_size),
                      default=batch_size)
            bucket = min(eff, bucket)
        if bucket > n:
            xs = [np.concatenate(
                [x, np.repeat(x[-1:], bucket - n, axis=0)], axis=0)
                for x in xs]
        elif bucket < n:
            eff = (tuple(b for b in self.batch_buckets if b <= bucket)
                   or (bucket,))
            outs, s = [], 0
            for m, b in plan_buckets(n, eff):
                outs.append(self.predict([x[s:s + m] for x in xs],
                                         batch_size=b))
                s += m
            if isinstance(outs[0], list):
                return [np.concatenate([o[i] for o in outs], axis=0)
                        for i in range(len(outs[0]))]
            return np.concatenate(outs, axis=0)
        self._note_shapes(xs)
        out = (self._bucket_forward(xs) if self._forward is None
               else self._forward(xs))
        if isinstance(out, (list, tuple)):
            return [np.asarray(o)[:n] for o in out]
        return np.asarray(out)[:n]

    def predict_classes(self, inputs, **kw) -> np.ndarray:
        out = self.predict(inputs, **kw)
        if isinstance(out, list):
            out = out[0]
        return np.argmax(out, axis=-1)


# ---------------------------------------------------------------------------
# Dynamic batching
# ---------------------------------------------------------------------------

class BatchRequest:
    """One queued request inside the DynamicBatcher: ``xs`` keep their
    leading batch dim (``n`` rows); ``callback(out, error)`` fires with
    the request's slice of the fused output (or the batch error).
    ``deadline`` (monotonic seconds, optional) is the record's client
    TTL: a request still unflushed past it is shed with a typed
    ``DeadlineExpired`` instead of wasting a device slot.  ``span``
    (optional observe.Span) is the record's batch_wait leg — the
    batcher ends it when the request flushes, sheds, or the batcher
    closes, so the request's timeline never dangles.  ``model`` names
    the target model in a multi-model pipeline (None = single-model
    legacy path); it rides into the bucket key so two models' requests
    never fuse, and into every per-request metric as a label."""

    __slots__ = ("xs", "n", "callback", "t_submit", "deadline", "span",
                 "model")

    def __init__(self, xs, callback, deadline=None, span=None, model=None):
        self.xs = xs
        self.n = xs[0].shape[0]
        self.callback = callback
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.span = span
        self.model = model


def scatter_batch_results(out, reqs: List[BatchRequest]) -> None:
    """Slice one fused model output back to the requests that formed it."""
    outs = out if isinstance(out, list) else [out]
    s = 0
    for r in reqs:
        sliced = [np.asarray(o)[s:s + r.n] for o in outs]
        r.callback(sliced if isinstance(out, list) else sliced[0], None)
        s += r.n


class DynamicBatcher:
    """Shape-bucketed continuous batching: stage 2 of the serving pipeline.

    Requests group by row shape/dtype (mixed-shape traffic never fuses —
    each shape is its own bucket feeding its own program) and a bucket
    dispatches on whichever comes first:

    - **batch-full** — ``max_batch`` rows accumulated (preempts the
      deadline: a hot bucket never waits);
    - **deadline** — ``max_latency_ms`` since the bucket's oldest
      request (trickle traffic is never stranded).

    Two front doors: blocking ``predict`` (drop-in concurrency helper)
    and async ``submit(xs, callback)`` (the serving pipeline's path).
    ``dispatch_fn(key, fused, reqs)`` hands full batches to an external
    executor (the serving DeviceExecutor); without one, batches run
    inline through ``model.predict``.
    """

    def __init__(self, model: Optional[InferenceModel] = None,
                 max_batch: int = 64, max_latency_ms: float = 5.0,
                 dispatch_fn: Optional[Callable] = None,
                 name: str = "serving",
                 heartbeat: Optional[Callable[[], None]] = None):
        if model is None and dispatch_fn is None:
            raise ValueError("DynamicBatcher needs a model or a "
                             "dispatch_fn")
        self.model = model
        self.max_batch = max_batch
        self.max_latency = max_latency_ms / 1e3
        self.name = name
        self._dispatch_fn = dispatch_fn
        self._heartbeat = heartbeat
        self._cv = threading.Condition()
        self._buckets: Dict[Any, List[BatchRequest]] = {}
        self._rows: Dict[Any, int] = {}
        self._deadline: Dict[Any, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _key(xs) -> Any:
        return tuple((tuple(x.shape[1:]), str(x.dtype)) for x in xs)

    # -- front doors -------------------------------------------------------
    def submit(self, inputs, callback: Callable,
               deadline: Optional[float] = None, span=None,
               model: Optional[str] = None) -> None:
        """Async enqueue; ``callback(out, error)`` fires from the
        dispatch side when this request's slice is ready.  ``deadline``
        (monotonic) sheds the request with ``DeadlineExpired`` if it is
        still queued when the bucket flushes past it.  ``span`` is the
        caller's batch_wait span, ended by the batcher at flush/shed.
        ``model`` scopes the bucket: requests for different models never
        fuse into one device batch."""
        if self._stop.is_set():
            raise RuntimeError("DynamicBatcher is closed")
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(x) for x in xs]
        req = BatchRequest(xs, callback, deadline=deadline, span=span,
                           model=model)
        key = self._key(xs) if model is None else (model,) + self._key(xs)
        full_reqs = None
        with self._cv:
            self._buckets.setdefault(key, []).append(req)
            self._rows[key] = self._rows.get(key, 0) + req.n
            self._deadline.setdefault(key, req.t_submit + self.max_latency)
            if self._rows[key] >= self.max_batch:
                # batch-full preempts the dispatcher thread: flush from
                # the submitting thread NOW rather than after the loop's
                # next GIL slot, so the device starts on batch N while
                # later requests are still being decoded/submitted
                full_reqs = self._buckets.pop(key)
                self._rows.pop(key, None)
                self._deadline.pop(key, None)
            self._cv.notify_all()
        if full_reqs is None:
            return
        groups, leftover = self._take(full_reqs, False)
        if leftover:
            with self._cv:
                self._buckets.setdefault(key, [])[:0] = leftover
                self._rows[key] = self._rows.get(key, 0) + sum(
                    r.n for r in leftover)
                self._deadline[key] = min(
                    self._deadline.get(key, float("inf")),
                    leftover[0].t_submit + self.max_latency)
        for g, full in groups:
            self._flush(key, g, full)

    def predict(self, inputs) -> Any:
        """Enqueue one request (single example or small batch); blocks
        until its slice of the fused batch returns."""
        done = threading.Event()
        slot: Dict[str, Any] = {}

        def cb(out, err):
            if err is not None:
                slot["error"] = err
            else:
                slot["out"] = out
            done.set()

        self.submit(inputs, cb)
        while not done.wait(timeout=1.0):
            if self._stop.is_set() and not done.is_set():
                # raced with close(): the worker may have exited before
                # popping this request — close() drains, but don't hang
                raise RuntimeError("DynamicBatcher closed while waiting")
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def close(self, flush: bool = False):
        """Stop the dispatcher.  ``flush=True`` dispatches whatever is
        buffered first (graceful pipeline drain); pending requests left
        after that fail with RuntimeError so no caller blocks forever."""
        if flush and not self._stop.is_set():
            with self._cv:
                groups = [(k, self._buckets.pop(k))
                          for k in list(self._buckets)]
                self._rows.clear()
                self._deadline.clear()
            for key, reqs in groups:
                self._flush(key, reqs, full=False)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=2)
        with self._cv:
            pending = [r for reqs in self._buckets.values() for r in reqs]
            self._buckets.clear()
            self._rows.clear()
            self._deadline.clear()
        for r in pending:
            if r.span is not None:
                r.span.end(status="closed")
            r.callback(None, RuntimeError("DynamicBatcher closed"))

    # -- dispatcher --------------------------------------------------------
    def _ready(self, now: float) -> List[Any]:
        full = [k for k, r in self._rows.items() if r >= self.max_batch]
        due = [k for k, d in self._deadline.items()
               if k not in full and d <= now and self._rows.get(k)]
        return full + due

    def _loop(self):
        while not self._stop.is_set():
            if self._heartbeat is not None:
                self._heartbeat()
            flushes = []
            with self._cv:
                now = time.monotonic()
                ready = self._ready(now)
                if not ready:
                    timeout = 0.05
                    if self._deadline:
                        timeout = min(timeout, max(
                            1e-4, min(self._deadline.values()) - now))
                    self._cv.wait(timeout=timeout)
                    now = time.monotonic()
                    ready = self._ready(now)
                for key in ready:
                    reqs = self._buckets.pop(key, [])
                    self._rows.pop(key, None)
                    deadline_hit = self._deadline.pop(key, now) <= now
                    if not reqs:
                        continue
                    groups, leftover = self._take(reqs, deadline_hit)
                    flushes.extend((key, g, f) for g, f in groups)
                    if leftover:
                        # a full-flush leaves the partial tail batching
                        # toward its own (original-arrival) deadline
                        self._buckets[key] = leftover
                        self._rows[key] = sum(r.n for r in leftover)
                        self._deadline[key] = (leftover[0].t_submit
                                               + self.max_latency)
            for key, reqs, full in flushes:
                self._flush(key, reqs, full)

    def _take(self, reqs, deadline_hit):
        """Pack requests into ≤max_batch-row groups (request boundaries
        respected; a single oversized request flushes alone)."""
        groups, cur, rows = [], [], 0
        for r in reqs:
            if cur and rows + r.n > self.max_batch:
                groups.append((cur, True))
                cur, rows = [], 0
            cur.append(r)
            rows += r.n
        leftover = []
        if cur:
            if rows >= self.max_batch or deadline_hit:
                groups.append((cur, rows >= self.max_batch))
            else:
                leftover = cur
        return groups, leftover

    def _flush(self, key, reqs: List[BatchRequest], full: bool) -> None:
        from analytics_zoo_tpu_torch.core.profiling import TIMERS
        from analytics_zoo_tpu_torch.observe import metrics as obs
        from analytics_zoo_tpu_torch.robust.errors import DeadlineExpired

        now = time.monotonic()
        expired = [r for r in reqs
                   if r.deadline is not None and now > r.deadline]
        if expired:
            # shed before paying the dispatch: the client's TTL already
            # elapsed while the request batched, so answer the typed
            # error now and keep the device slot for live work
            for r in expired:
                obs.count("serving_shed_total", code="expired",
                          model=r.model or DEFAULT_MODEL,
                          flat=f"{self.name}/shed_expired")
            err = DeadlineExpired(
                "client TTL expired while the request batched")
            for r in expired:
                if r.span is not None:
                    r.span.end(status="expired")
                r.callback(None, err)
            reqs = [r for r in reqs if r not in expired]
            if not reqs:
                return
        TIMERS.incr(f"{self.name}/flush_full" if full
                    else f"{self.name}/flush_deadline")
        for r in reqs:
            obs.observe("serving_stage_seconds", now - r.t_submit,
                        stage="batch_wait", model=r.model or DEFAULT_MODEL,
                        flat=f"{self.name}/batch_wait")
            if r.span is not None:
                r.span.end(rows=r.n, full=full)
        try:
            if len(reqs) == 1:
                # single-request batch: hand the arrays through as-is —
                # on the shm backend these are views into the slot, and
                # this is the last place a host copy could sneak in
                # before the copy into the bucket's staging buffer
                fused = list(reqs[0].xs)
            else:
                TIMERS.incr(f"{self.name}/batch_fuse_copies")
                fused = [np.concatenate([r.xs[i] for r in reqs], axis=0)
                         for i in range(len(reqs[0].xs))]
            if self._dispatch_fn is not None:
                self._dispatch_fn(key, fused, reqs)
                return
            out = self.model.predict(fused)
            scatter_batch_results(out, reqs)
        except Exception as e:  # surface errors to every waiter
            for r in reqs:
                r.callback(None, e)
