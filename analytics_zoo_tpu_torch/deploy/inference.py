"""InferenceModel: thread-safe serving model, and the DynamicBatcher.

- One model serves any number of threads: the forward mutates nothing, so
  concurrency policy is *batching* policy (``DynamicBatcher``).
- Shape buckets: requests pad up to the next bucket, and larger batches
  split into full-bucket chunks (``plan_buckets``), so the set of batch
  shapes the device sees stays bounded.
- int8 / int4 weights: per-output-channel symmetric quantization, with
  the JAX package's rule and leaf format (``quantize_pytree``).  Dense
  kernels stay packed end to end and run through the fused
  dequantize-matmul kernel; every other quantized leaf (the embedding
  tables) is stored quantized and dequantized in the forward
  (``nn.module.Layer.leaf``).  That is the JAX package's
  ``_dequant_for_forward`` rule; it needs no tree transform here, and no
  ``_dense_layer_names``, because each layer owns its leaves and reads
  them in the form it can use.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.context import resolve_device
from analytics_zoo_tpu_torch.nn.module import is_qleaf

__all__ = ["InferenceModel", "DynamicBatcher", "BatchRequest",
           "scatter_batch_results", "quantize_pytree", "dequantize_pytree",
           "plan_buckets", "DEFAULT_MODEL"]

# the implicit model name for single-model serving paths
DEFAULT_MODEL = "default"
WEIGHT_DTYPES = ("float32", "int8", "int4")


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def plan_buckets(n: int, buckets: Sequence[int]) -> List[tuple]:
    """Split ``n`` rows into ``[(rows, bucket), ...]`` chunks: full
    ``buckets[-1]``-row chunks first, then one tail chunk padded up to its
    nearest bucket."""
    out: List[tuple] = []
    cap = buckets[-1]
    s = 0
    while s < n:
        m = min(n - s, cap)
        out.append((m, _next_bucket(m, buckets)))
        s += m
    return out


def _f32_out(out):
    def cast(o):
        o = o.float() if o.is_floating_point() else o
        return o.cpu().numpy()

    return ([cast(o) for o in out]
            if isinstance(out, (list, tuple)) else cast(out))


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
# InferenceModel
# ---------------------------------------------------------------------------

class InferenceModel:
    """Thread-safe model for serving.

        m = InferenceModel.from_keras_net(net, weight_dtype="int8")

    then ``m.predict(inputs)`` from any number of threads.
    """

    def __init__(self, forward: Callable, batch_buckets: Sequence[int] =
                 (1, 8, 64, 256), name: str = DEFAULT_MODEL):
        """``forward``: fn(list_of_np_inputs_padded) -> np output(s) for a
        full padded batch.  Wrapped by bucket padding in predict()."""
        self._forward = forward
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.name = str(name)
        # batch-signature ledger: one entry per distinct padded batch
        # shape dispatched — the bounded-shape contract of the buckets
        self._seen_shapes = set()
        self._shape_lock = threading.Lock()
        self._net = None
        self._weight_dtype = "float32"
        self.device: Optional[torch.device] = None

    def _note_shapes(self, xs) -> None:
        """Record the batch signature about to be dispatched."""
        sig = tuple((tuple(np.shape(x)), str(getattr(x, "dtype", "")))
                    for x in xs)
        with self._shape_lock:
            if sig in self._seen_shapes:
                return
            self._seen_shapes.add(sig)
            live = len(self._seen_shapes)
        from analytics_zoo_tpu_torch.observe import metrics as obs

        obs.count("inference_novel_batch_shapes_total", model=self.name,
                  flat="inference/novel_batch_shape")
        obs.set_gauge("inference_compile_count", live, model=self.name)

    @property
    def compile_count(self) -> int:
        """Number of distinct batch signatures dispatched."""
        with self._shape_lock:
            return len(self._seen_shapes)

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
    def from_keras_net(cls, net, params=None, int8: bool = False,
                       weight_dtype: Optional[str] = None, device=None,
                       **kw) -> "InferenceModel":
        """Wrap a built net as a serving model on ``device`` (default
        ``cuda``; raises when there is none).

        The net is copied, so the caller's stays as it is.  ``params``
        (a JAX-layout tree of numpy arrays or tensors, plain or already
        quantized) replaces its weights by layer and leaf name.
        ``weight_dtype``: "float32", "int8" or "int4"; ``None`` resolves
        the legacy ``int8`` flag, then the ``serving_weight_dtype`` knob.
        """
        from analytics_zoo_tpu_torch.convert import load_jax_params

        device = resolve_device(device)
        weight_dtype = cls._resolve_weight_dtype(weight_dtype, int8)
        net = copy.deepcopy(net).cpu()
        if params is not None:
            load_jax_params(net, params)
        if weight_dtype != "float32":
            load_jax_params(net, quantize_pytree(
                net.params(), bits=4 if weight_dtype == "int4" else 8))
        net = net.to(device).eval()

        def forward(inputs: List[np.ndarray]):
            with torch.inference_mode():
                xs = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                      for x in inputs]
                return _f32_out(net(*xs))

        m = cls(forward, **kw)
        m._net, m._weight_dtype, m.device = net, weight_dtype, device
        return m

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
        out = self._forward(xs)
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
    ``deadline`` (monotonic seconds, optional) is the client TTL: a
    request still unflushed past it is shed with ``DeadlineExpired``."""

    __slots__ = ("xs", "n", "callback", "t_submit", "deadline")

    def __init__(self, xs, callback, deadline=None):
        self.xs = xs
        self.n = xs[0].shape[0]
        self.callback = callback
        self.t_submit = time.monotonic()
        self.deadline = deadline


def scatter_batch_results(out, reqs: List[BatchRequest]) -> None:
    """Slice one fused model output back to the requests that formed it."""
    outs = out if isinstance(out, list) else [out]
    s = 0
    for r in reqs:
        sliced = [np.asarray(o)[s:s + r.n] for o in outs]
        r.callback(sliced if isinstance(out, list) else sliced[0], None)
        s += r.n


class DynamicBatcher:
    """Shape-bucketed continuous batching.

    Requests group by row shape/dtype and a bucket dispatches on
    whichever comes first:

    - **batch-full** — ``max_batch`` rows accumulated (flushed from the
      submitting thread at once);
    - **deadline** — ``max_latency_ms`` since the bucket's oldest request.

    Two front doors: blocking ``predict`` and async ``submit(xs,
    callback)``.  Batches run inline through ``model.predict``.
    """

    def __init__(self, model: InferenceModel, max_batch: int = 64,
                 max_latency_ms: float = 5.0, name: str = "serving"):
        self.model = model
        self.max_batch = max_batch
        self.max_latency = max_latency_ms / 1e3
        self.name = name
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
               deadline: Optional[float] = None) -> None:
        """Async enqueue; ``callback(out, error)`` fires from the
        dispatch side when this request's slice is ready.  ``deadline``
        (monotonic) sheds the request with ``DeadlineExpired`` if it is
        still queued when its bucket flushes past it."""
        if self._stop.is_set():
            raise RuntimeError("DynamicBatcher is closed")
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(x) for x in xs]
        req = BatchRequest(xs, callback, deadline=deadline)
        key = self._key(xs)
        full_reqs = None
        with self._cv:
            self._buckets.setdefault(key, []).append(req)
            self._rows[key] = self._rows.get(key, 0) + req.n
            self._deadline.setdefault(key, req.t_submit + self.max_latency)
            if self._rows[key] >= self.max_batch:
                # batch-full: flush from the submitting thread now
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
            self._flush(g, full)

    def predict(self, inputs) -> Any:
        """Enqueue one request; blocks until its slice of the fused batch
        returns."""
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
                raise RuntimeError("DynamicBatcher closed while waiting")
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def close(self, flush: bool = False):
        """Stop the dispatcher.  ``flush=True`` dispatches whatever is
        buffered first; pending requests left after that fail with
        RuntimeError so no caller blocks forever."""
        if flush and not self._stop.is_set():
            with self._cv:
                groups = [self._buckets.pop(k) for k in list(self._buckets)]
                self._rows.clear()
                self._deadline.clear()
            for reqs in groups:
                self._flush(reqs, full=False)
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
            r.callback(None, RuntimeError("DynamicBatcher closed"))

    # -- dispatcher --------------------------------------------------------
    def _ready(self, now: float) -> List[Any]:
        full = [k for k, r in self._rows.items() if r >= self.max_batch]
        due = [k for k, d in self._deadline.items()
               if k not in full and d <= now and self._rows.get(k)]
        return full + due

    def _loop(self):
        while not self._stop.is_set():
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
                    flushes.extend(groups)
                    if leftover:
                        # the partial tail keeps batching toward its own
                        # (original-arrival) deadline
                        self._buckets[key] = leftover
                        self._rows[key] = sum(r.n for r in leftover)
                        self._deadline[key] = (leftover[0].t_submit
                                               + self.max_latency)
            for reqs, full in flushes:
                self._flush(reqs, full)

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

    def _flush(self, reqs: List[BatchRequest], full: bool) -> None:
        from analytics_zoo_tpu_torch.core.profiling import TIMERS
        from analytics_zoo_tpu_torch.observe import metrics as obs
        from analytics_zoo_tpu_torch.robust.errors import DeadlineExpired

        now = time.monotonic()
        expired = [r for r in reqs
                   if r.deadline is not None and now > r.deadline]
        if expired:
            # shed before paying the dispatch: the client's TTL elapsed
            # while the request batched
            model = self.model.name
            obs.count("serving_shed_total", len(expired), code="expired",
                      model=model, flat=f"{self.name}/shed_expired")
            err = DeadlineExpired(
                "client TTL expired while the request batched")
            for r in expired:
                r.callback(None, err)
            reqs = [r for r in reqs if r not in expired]
            if not reqs:
                return
        TIMERS.incr(f"{self.name}/flush_full" if full
                    else f"{self.name}/flush_deadline")
        for r in reqs:
            obs.observe("serving_stage_seconds", now - r.t_submit,
                        stage="batch_wait", model=self.model.name,
                        flat=f"{self.name}/batch_wait")
        try:
            if len(reqs) == 1:
                fused = list(reqs[0].xs)
            else:
                TIMERS.incr(f"{self.name}/batch_fuse_copies")
                fused = [np.concatenate([r.xs[i] for r in reqs], axis=0)
                         for i in range(len(reqs[0].xs))]
            out = self.model.predict(fused)
            scatter_batch_results(out, reqs)
        except Exception as e:  # surface errors to every waiter
            for r in reqs:
                r.callback(None, e)
