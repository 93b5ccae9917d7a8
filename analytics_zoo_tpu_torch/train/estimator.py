"""Estimator — training, evaluation and prediction over a port model.

The JAX package's ``train/estimator.py`` on one device, in PyTorch: the
model (a ``KerasNet``) owns its weights as ``nn.Parameter``s, and each
train step is forward, loss (+ the layers' weight penalties), one
``torch.autograd.grad``, and the optimizer's update (``train.optimizers``)
over the trainable parameters flattened into one f32 vector.  Every
embedding lookup's backward is the embedding-bag scatter kernel on the
card (``ops.embedding_bag``).

What carries over from the JAX design:

- **Shuffle.** Host arrays are permuted each epoch by
  ``np.random.RandomState(ZooConfig.seed)``, reset at every ``fit``
  without ``resume``, so the port replays the JAX package's batches
  exactly.  The last partial batch is dropped, with a warning.
- **Data paths** (``last_data_path``): host numpy arrays are gathered per
  batch on a prefetch thread into pinned buffers and copied on a side
  stream (``host_prefetch``, ``train/prefetch.py``, ``data_prefetch``
  batches ahead); tensors are moved to the device once and every epoch's
  permutation and gathers run there (``device_resident``).  A
  ``FeatureSet`` goes through the JAX package's router
  (``_resolve_data_path``, counted in ``data_path_selected_total``): by
  its cache level and ``ZooConfig.data_device_budget_bytes`` it trains
  resident, from host batches (K per dispatch under
  ``steps_per_execution``), or through the STREAM tier
  (``data/streaming.py``): budget-sized shards rotate through
  ``data_stream_slots`` device slots, and each shard trains as one
  captured program per slot, its rows permuted and gathered on the
  device, quantized features decoded after the gather.  An upload that
  fails mid-epoch (faults ``data.shard_upload``, ``data.shard_torn``)
  finishes the epoch's shards from host batches and is counted in
  ``data_stream_fallbacks_total``; a preemption flushes the shard
  cursor, and a resume restarts at that shard.
- **Layer state** (BatchNormalization's moving statistics,
  ``nn/module.py``): the training forward hands its new values to the
  step, which commits them into the live buffers after the loss is
  known, with ``torch.where`` on the guard's verdict, so a non-finite
  step keeps the old state as the JAX step's ``keep_if_finite`` does.
  State is not in the flat vector, so freezing a layer stops its
  parameters and not its statistics, as in the JAX step.  ``evaluate``
  and ``predict`` read the moving statistics.
- **Mixed precision.** ``compute_dtype="bfloat16"`` runs the forward and
  backward on bf16 copies of every float parameter, float state leaf and
  float input (``torch.func.functional_call``), LayerNorm, GELU and
  softmax included, as the JAX package casts its trees; the new state is
  cast back to f32 when committed; the f32 master vector and the
  optimizer state stay f32, the predictions come back to f32 for the
  loss, and the regularizers read the f32 masters.  Not ``autocast``,
  which would keep LayerNorm and softmax in f32.
- **Gradient accumulation** (``grad_accum_steps``) wraps the optimizer in
  ``optimizers.multi_steps`` (optax.MultiSteps); clipping sits inside it.
- **Freezing** (``nn.net.GraphNet.freeze``): a frozen top-level layer's
  update is zero while its optimizer moments go on updating, as in the
  JAX step; the frozen set is read at every ``fit``.
- **NaN/Inf guard.** A step whose loss is not finite leaves the
  parameters and the optimizer state as they were (``torch.where`` on
  the device) and is counted; ``ZooConfig.nan_policy`` is applied at the
  epoch boundary, and ``rollback`` restores the last checkpoint and
  scales every later update by a device scalar, ``lr_scale``.
- **No per-step host reads.** The guard's counters and the loss sums
  stay on the device and are read back once per epoch.
- **One dispatch per step, or per K steps** (``core/graphs.py``).  A
  training step updates every piece of its state in place — the
  parameters, the optimizer state, the guard, the loss sums, read with
  ``lr_scale`` and a NaN-fault scalar from device tensors the host fills
  between dispatches — so on the card it is captured once into a CUDA
  graph and replayed: the counterpart of the JAX package's one jitted
  step.  ``steps_per_execution = K`` captures K steps over a (K·B)-row
  superbatch copied into the graph's static inputs (the ``lax.scan``);
  an epoch's ``steps % K`` tail steps run one at a time, as in the JAX
  package.  The device-resident path keeps the epoch's permutation in a
  static buffer and the batch offset in a device counter the graph
  advances, so one graph of K steps (or one) serves every chunk of every
  epoch: the counterpart of the JAX package's one program per epoch,
  replayed ``steps / K`` times.  A program's first step runs eagerly (its
  warm-up), the next captures; programs are kept by their shapes and
  dropped when the tensors they hold change (a new optimizer state,
  replaced parameters, another frozen set).  An estimator's programs
  capture into one memory pool, since they never replay at once.  On
  the CPU the same static-buffer code runs eagerly.
- **Evaluation and prediction** run as programs too: one eval and one
  predict program per input signature, each batch padded to the batch
  size with a device mask over the padded rows (the JAX package's
  ``_pad_to_devices`` and eval step): a per-row loss is summed under the
  mask, a loss that couples rows and takes a mask weighs by its own unit
  count, one that couples rows without a mask runs on the whole batch.
  Metric statistics add into device accumulators inside the program, so
  an ``evaluate`` pass reads the host once and ``predict`` once per
  batch.  Mid-fit validation goes through them.
- **Observability** (the JAX package's): ``train/fit``, ``train/epoch``
  and ``train/step`` spans; ``train_epoch_seconds``, ``train_loss`` and
  ``train_throughput_rows_per_s``; ``set_tensorboard`` writes each
  epoch's and each validation's scalars (``core/summary.py``);
  ``training_report``, ``metrics_text``, ``publish_metrics`` and
  ``arm_flight_recorder``.
- **Checkpoints and resume** (``set_checkpoint``, ``fit(resume=True)``,
  ``train/checkpoint.py``): a snapshot holds the parameters and the
  state (the JAX trees), the flat optimizer state, and ``meta`` — the step and epoch
  counters, ``lr_scale``, the pickled host ``RandomState`` at the
  snapshot and at its epoch's start, the dropout generator's state
  (``torch_rng``) and the epoch's loss and guard accumulators.  A
  SIGTERM during ``fit`` flushes one synchronous checkpoint at the next
  step boundary and raises ``TrainingPreempted``; a resumed host-array
  run redraws the interrupted epoch's permutation and skips the steps
  already trained, landing on the uninterrupted run's trajectory (the
  other paths resume at epoch boundaries).  A failing epoch is retried
  from the last checkpoint (``failure_retry_times`` within
  ``failure_retry_interval_s``).

The distributed checkpoint and multi-GPU training (and with them the
stream tier's multi-controller parts) are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import signal
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.core import graphs
from analytics_zoo_tpu_torch.core.context import (ZooContext, get_zoo_context,
                                                  resolve_device)
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.core.triggers import (EveryEpoch, Trigger,
                                                   TriggerState)
from analytics_zoo_tpu_torch.nn import metrics as metrics_lib
from analytics_zoo_tpu_torch.nn import module as module_lib
from analytics_zoo_tpu_torch.nn import objectives
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.observe.export import (publish_to_summary,
                                                    to_prometheus)
from analytics_zoo_tpu_torch.observe.trace import TRACER
from analytics_zoo_tpu_torch.robust import (RetryPolicy, TrainingPreempted,
                                            faults)
from analytics_zoo_tpu_torch.train import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.train import optimizers as optim_lib
from analytics_zoo_tpu_torch.train import prefetch as prefetch_lib

logger = logging.getLogger("analytics_zoo_tpu_torch.train")

NAN_POLICIES = ("skip", "raise", "rollback")


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _pair_perm(pairs, n):
    """Row order from a permutation of (pos, neg) pairs, numpy or torch:
    partners stay adjacent (pair-structured losses such as
    ``rank_hinge``); an odd last row goes last."""
    if isinstance(pairs, torch.Tensor):
        idx = torch.stack([pairs * 2, pairs * 2 + 1], 1).reshape(-1)
        tail = torch.full((n % 2,), n - 1, dtype=idx.dtype,
                          device=idx.device)
        return torch.cat([idx, tail])
    idx = np.stack([pairs * 2, pairs * 2 + 1], 1).reshape(-1)
    return np.concatenate([idx, np.full(n % 2, n - 1, idx.dtype)])


def _compute_dtype(name) -> Optional[torch.dtype]:
    """``None`` for f32 compute, else the torch float dtype named."""
    if name in (None, "float32"):
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must name a float dtype, got "
                         f"{name!r}")
    return dtype


def _to_f32(preds):
    if isinstance(preds, (list, tuple)):
        return type(preds)(_to_f32(p) for p in preds)
    return preds.float() if preds.is_floating_point() else preds


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _has_float(arrays) -> bool:
    return any(np.issubdtype(a.dtype, np.floating) for a in arrays)


def _spans(steps: int, k: int) -> List[tuple]:
    """An epoch's dispatches as in-epoch step ranges: ``steps // k``
    chunks of ``k`` steps, then the tail one step at a time (the JAX
    package's rule)."""
    n_chunks = steps // k if k > 1 else 0
    return ([(c * k, (c + 1) * k) for c in range(n_chunks)]
            + [(s, s + 1) for s in range(n_chunks * k, steps)])


class _ResidentFeed:
    """The device-resident path's static inputs: the arrays, the epoch's
    permutation (filled each epoch) and the batch offset, a device
    counter the step programs advance."""

    def __init__(self, arrays, n: int, batch: int, device):
        self.arrays = list(arrays)
        self.batch = batch
        self.perm = torch.empty(n, dtype=torch.int64, device=device)
        self.offset = torch.zeros((), dtype=torch.int64, device=device)
        self.lanes = torch.arange(batch, dtype=torch.int64, device=device)
        self.key = self.key_of(arrays, n, batch)

    @staticmethod
    def key_of(arrays, n: int, batch: int) -> tuple:
        """What a feed's programs hold: the arrays' tensors and shapes."""
        return (n, batch) + tuple((id(a), a.data_ptr(), a.shape)
                                  for a in arrays)

    def rows(self):
        """The next batch (a list of gathered arrays), advancing the
        offset on the device."""
        idx = self.perm.index_select(0, self.offset + self.lanes)
        self.offset.add_(self.batch)
        return [a.index_select(0, idx) for a in self.arrays]


class _StreamFeed:
    """One STREAM slot as a shard program's input: its device tensors
    (rows, or ``(q, scale, zero)`` for a quantized array) and the
    in-shard permutation.  Step ``j`` gathers rows ``perm[j*B:(j+1)*B]``
    of every array and decodes the quantized ones after the gather."""

    def __init__(self, slots, slot: int, batch: int):
        self.views, self.perm = slots.slots[slot].views()
        self.batch = batch
        self.key = (slot,) + slots.key

    def rows(self, j: int):
        from analytics_zoo_tpu_torch.ops.quantization import \
            dequantize_features

        idx = self.perm[j * self.batch:(j + 1) * self.batch]
        return [a.index_select(0, idx) if isinstance(a, torch.Tensor)
                else dequantize_features(a[0].index_select(0, idx), a[1],
                                         a[2])
                for a in self.views]


class _StepProgram:
    """``k`` train steps over static inputs, as one ``StepGraph``: host
    batches are copied into the program's own buffers before each run;
    resident batches are gathered inside it from the feed, and a STREAM
    shard's from its slot (``_StreamFeed``).  The step
    function holds the estimator weakly and the program not at all, so
    no reference cycle keeps a graph's memory alive after its owner."""

    def __init__(self, est: "Estimator", kind: str, feed, k: int, params,
                 mask):
        dev = est.device
        owner = weakref.ref(est)

        def step(*args):
            owner()._train_step(*args)

        self.kind = kind
        self.nan_scale = nan_scale = torch.ones((), dtype=torch.float32,
                                                device=dev)
        self._nan = False
        self.static = static = ([torch.empty_like(t) for t in feed]
                                if kind == "host" else None)
        if kind == "host":
            b = feed[0].shape[0] // k

            def fn():
                for j in range(k):
                    rows = [t[j * b:(j + 1) * b] for t in static]
                    step(params, rows[:-1], rows[-1], mask, nan_scale)
        elif kind == "resident":
            def fn():
                for _ in range(k):
                    rows = feed.rows()
                    step(params, rows[:-1], rows[-1], mask, nan_scale)
        else:
            def fn():
                for j in range(k):
                    rows = feed.rows(j)
                    step(params, rows[:-1], rows[-1], mask, nan_scale)

        self.graph = graphs.StepGraph(
            fn, dev, generators=est._generators, pool=est._graph_pool(),
            name=f"train step ({kind}, {k} step{'s' if k > 1 else ''})")

    def run(self, feed, nan_loss: bool) -> None:
        if self.kind == "host":
            for t, src in zip(self.static, feed):
                t.copy_(src)
        if nan_loss != self._nan:
            self.nan_scale.fill_(float("nan") if nan_loss else 1.0)
            self._nan = nan_loss
        self.graph()


class _EvalProgram:
    """One evaluate ("eval") or predict ("predict") batch signature as a
    ``StepGraph`` over static inputs: the features, and for "eval" the
    label and the row mask, filled before each run.  "eval" adds the
    batch's loss and metric statistics into device accumulators (made by
    the eager warm-up, zeroed by the caller before a pass); "predict"
    returns its static outputs.  The function holds the estimator
    weakly and the program not at all."""

    def __init__(self, est: "Estimator", kind: str, specs, batch: int):
        dev = est.device
        owner = weakref.ref(est)
        self.static = static = [torch.empty((batch,) + tuple(shape),
                                            dtype=dtype, device=dev)
                                for shape, dtype in specs]
        self.acc = acc = []
        if kind == "eval":
            def fn():
                with torch.no_grad():
                    stats = owner()._eval_stats(static[:-2], static[-2],
                                                static[-1])
                    if not acc:
                        acc.extend(torch.zeros_like(t) for t in stats)
                    torch._foreach_add_(acc, stats)
        else:
            def fn():
                with torch.no_grad():
                    return owner()._eval_forward(static)
        self.graph = graphs.StepGraph(
            fn, dev, pool=est._graph_pool(eval_pool=True),
            name=f"{kind} (batch {batch})")

    def run(self, tensors):
        """Fill the static inputs (host rows through pinned memory on the
        card, so the copy queues behind the last replay without a wait)
        and run the program."""
        for t, src in zip(self.static, tensors):
            if t.is_cuda and not src.is_cuda:
                src = src.pin_memory()
            t.copy_(src, non_blocking=True)
        return self.graph()


def _pickled(state) -> np.ndarray:
    return np.frombuffer(pickle.dumps(state), np.uint8)


def _unpickled(meta, key):
    a = meta.get(key)
    if a is None or not np.asarray(a).size:
        return None
    return pickle.loads(np.asarray(a).tobytes())


class Estimator:
    """fit / evaluate / predict over a ``KerasNet`` on one device.

    The JAX signature, with the port's ``device`` after it.  ``sharding``
    is "dp" (one device; the other regimes raise until the multi-GPU
    slice, ROADMAP A9).  ``compute_dtype`` defaults to
    ``ZooConfig.compute_dtype``; ``aux_loss_weight`` is accepted and inert
    until the layers that emit auxiliary losses are ported (``moe.py``,
    A9); ``grad_accum_steps`` > 1 applies one update per that many
    batches.  ``device`` defaults to the context's, else ``cuda``
    (raising when there is none); pass ``device="cpu"`` to train on the
    CPU.
    """

    def __init__(self, model, optimizer="adam", loss="mse",
                 metrics: Optional[Sequence] = None,
                 ctx: Optional[ZooContext] = None,
                 grad_clip_norm: Optional[float] = None,
                 grad_clip_value: Optional[float] = None,
                 sharding="dp", compute_dtype: Optional[str] = None,
                 aux_loss_weight: float = 0.01,
                 grad_accum_steps: int = 1, device=None):
        if sharding != "dp":
            raise NotImplementedError(
                f"sharding={sharding!r} (the sequence-parallel, pipeline and "
                f"model-parallel regimes) needs the multi-GPU slice "
                f"(ROADMAP A9); the port trains on one device")
        self.model = model
        self.aux_loss_weight = aux_loss_weight
        self._sharding_strategy = sharding
        tx = optim_lib.get(optimizer)
        # clip wraps the base optimizer inside the accumulation, so it
        # sees the accumulated mean gradient
        if grad_clip_norm is not None:
            tx = optim_lib.chain(optim_lib.clip_by_global_norm(grad_clip_norm),
                                 tx)
        elif grad_clip_value is not None:
            tx = optim_lib.chain(optim_lib.clip(grad_clip_value), tx)
        if grad_accum_steps > 1:
            tx = optim_lib.multi_steps(tx, grad_accum_steps)
        self.tx = tx
        self.grad_accum_steps = grad_accum_steps
        self.loss_fn = objectives.get(loss)
        self.metrics = [metrics_lib.get(m) for m in (metrics or [])]
        self.ctx = ctx or get_zoo_context()
        self.device = resolve_device(device)
        self.compute_dtype = _compute_dtype(
            compute_dtype or self.ctx.config.compute_dtype)

        self.opt_state: Optional[List[torch.Tensor]] = None
        self.global_step = 0
        self.finished_epochs = 0
        self.history: List[Dict[str, float]] = []
        # which input path the last fit() ran ("device_resident" or
        # "host_prefetch") and why
        self.last_data_path: Optional[str] = None
        self.last_data_path_reason: Optional[str] = None

        self._initial = None            # (params, state) for the build
        self._built = False
        self._state_numel = 0
        self._host_rng = np.random.RandomState(self.ctx.config.seed)
        self._dropout_gen: Optional[torch.Generator] = None
        self._val_trigger: Optional[Trigger] = None
        self._val_batch: Optional[int] = None
        self._last_val_iter = -1
        self._last_val_result: Optional[Dict[str, float]] = None
        # per-epoch device accumulators: [loss sum, finite steps] and the
        # guard's [bad steps, consecutive bad, max consecutive bad]
        self._loss_acc: Optional[torch.Tensor] = None
        self._guard: Optional[torch.Tensor] = None
        # checkpoints and resilience: the NaN-rollback learning-rate
        # scale (host value, and its device copy the step reads), a
        # restore waiting for the model to be built, the resume manifest
        # (epoch, in-epoch step, epoch-start host rng state, the epoch's
        # accumulators) and the preemption request
        self._ckpt_mgr: Optional[ckpt_lib.CheckpointManager] = None
        self._ckpt_trigger: Trigger = EveryEpoch()
        self._lr_scale = 1.0
        self._lr_scale_t: Optional[torch.Tensor] = None
        self._restore_pending = False
        self._pending_resume = None
        self._preempt = threading.Event()
        self._sigterm_handled = False
        # the step programs (graphs on the card) by dispatch key, valid
        # while the tensors they hold stay the live ones (_programs_key);
        # the cached update mask and its key; the resident path's feed;
        # the generators the captured steps draw from; the memory pool
        # the programs' graphs share (they never replay at the same time)
        self._programs: Dict[tuple, "_StepProgram"] = {}
        self._programs_key = None
        self._pool = None
        self._mask_key = None
        self._mask = None
        self._feed: Optional[_ResidentFeed] = None
        self._generators: tuple = ()
        # the STREAM tier: the router's plan and the device slots the
        # shard programs read (kept while the plan's geometry holds)
        self._stream_plan = None
        self._stream_slots = None
        # evaluate / predict programs by signature, valid while the
        # tensors they read stay the live ones (_eval_key); their pool
        self._eval_programs: Dict[tuple, _EvalProgram] = {}
        self._eval_key = None
        self._eval_pool = None
        self._eval_metric_keys: List[List[str]] = []
        # observability: the TensorBoard writer, the fit's root span and
        # the current epoch's (step spans parent under it), the metric
        # snapshot at fit() entry (training_report deltas it), and the
        # flight recorder checked at epoch ends
        self._tb_writer = None
        self._fit_span = None
        self._epoch_span = None
        self._fit_metrics_mark = None
        self._flight_recorder = None

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def set_checkpoint(self, path: str, over_write: bool = True,
                       trigger: Optional[Trigger] = None, keep: int = 3):
        """Snapshots under ``path`` when ``trigger`` fires (default: every
        epoch), the newest ``keep`` kept.  ``over_write`` is accepted for
        the reference's signature: step-numbered snapshots never collide
        with older ones."""
        self._ckpt_mgr = ckpt_lib.CheckpointManager(
            path, keep=keep, verify=self.ctx.config.ckpt_verify)
        if trigger is not None:
            self._ckpt_trigger = trigger
        return self

    def set_tensorboard(self, log_dir: str):
        """Write each epoch's and each validation's scalars (loss,
        throughput, ``val_*``) as TensorBoard events under ``log_dir``
        (``core/summary.py``; ``read_scalars`` reads them back)."""
        from analytics_zoo_tpu_torch.core.summary import SummaryWriter

        self._tb_writer = SummaryWriter(log_dir)
        return self

    def arm_flight_recorder(self, *, window_s: float = 5.0,
                            out_dir: Optional[str] = None,
                            watch: Optional[Sequence] = None, **kw):
        """A training-side flight recorder, checked at each epoch's end:
        a stream-tier fallback (``data_stream_fallbacks_total``) trips a
        snapshot of the span ring and the metric window.  Extra
        ``watch`` pairs and ``FlightRecorder`` keywords pass through.
        Returns the recorder."""
        from analytics_zoo_tpu_torch.observe.recorder import FlightRecorder

        counters = [("data_stream_fallbacks_total", {})]
        if watch:
            counters.extend(watch)
        self._flight_recorder = FlightRecorder(
            watch_counters=counters, window_s=window_s, out_dir=out_dir,
            **kw)
        self._flight_recorder.check()       # open the first window
        return self._flight_recorder

    def training_report(self) -> Dict[str, Any]:
        """The fit() counterpart of serving's ``health()``: progress, the
        labelled-metric delta since the last ``fit()`` began (step and
        epoch times, data path, checkpoints, loss and throughput gauges)
        and the span ring's counts."""
        report: Dict[str, Any] = {
            "global_step": self.global_step,
            "finished_epochs": self.finished_epochs,
            "last_data_path": self.last_data_path,
            "history": list(self.history),
            "spans": {"completed": TRACER.completed_count(),
                      "active": TRACER.active_count(),
                      "ring": TRACER.ring_size()},
        }
        if self._fit_span is not None:
            report["fit_trace"] = self._fit_span.trace
        if self._fit_metrics_mark is not None:
            report["metrics_delta"] = obs.METRICS.delta(
                self._fit_metrics_mark)
        return report

    def metrics_text(self) -> str:
        """The labelled metric registry in Prometheus text format."""
        return to_prometheus(obs.METRICS)

    def publish_metrics(self, step: Optional[int] = None) -> int:
        """The labelled registry into the ``set_tensorboard`` writer (0
        without one); returns the number of scalars written."""
        if self._tb_writer is None:
            return 0
        wrote = publish_to_summary(self._tb_writer,
                                   self.global_step if step is None
                                   else step)
        self._tb_writer.flush()
        return wrote

    def load_checkpoint(self, directory: str):
        """Restore the newest intact snapshot in ``directory`` (at once
        when the model is built, else at its build)."""
        self.set_checkpoint(directory)
        self._restore_pending = True
        if self._built:
            self._ensure_built([])
        return self

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def set_initial_weights(self, params, state=None):
        """Weights, and state, applied by layer name at the first build
        instead of the built ones (applied at once, with a fresh optimizer
        state, when already built).  ``params`` and ``state`` are the JAX
        layout ``{layer: {leaf: array}}``; a layer ``state`` does not
        name keeps its state."""
        self._initial = (params, state)
        if self._built:
            self._load_initial()
            self._init_opt_state()
        return self

    def _load_initial(self):
        from analytics_zoo_tpu_torch.convert import load_jax_params

        (given, given_state), self._initial = self._initial, None
        current = self.model.params()
        missing = sorted(set(current) - set(given))
        if missing:
            logger.warning("initial weights cover %d/%d layers; these keep "
                           "their RANDOM init: %s",
                           len(current) - len(missing), len(current),
                           missing)
        state = self.model.state()
        load_jax_params(self.model, {k: given.get(k, v)
                                     for k, v in current.items()},
                        {k: (given_state or {}).get(k, v)
                         for k, v in state.items()})
        self.model.to(self.device)

    def _ensure_built(self, inputs):
        if not self._built:
            if getattr(self.model, "_output_shape", None) is None:
                shapes = [(2,) + tuple(x.shape[1:]) for x in inputs]
                self.model.build(torch.Generator().manual_seed(
                    self.ctx.config.seed), *shapes)
            self.model.to(self.device)
            if self._initial is not None:
                self._load_initial()
            self._dropout_gen = torch.Generator(
                device=self.device).manual_seed(self.ctx.config.seed)
            self._built = True
        self.model.to(self.device)
        numel = sum(p.numel() for p in self._trainable())
        if self.opt_state is None or self._state_numel != numel:
            self._init_opt_state()
        if self._restore_pending:
            self._restore_pending = False
            self._restore_checkpoint()

    def _init_opt_state(self):
        flat = self._flat(self._trainable())
        self.opt_state = self.tx.init(flat)
        self._state_numel = flat.numel()

    def _trainable(self) -> List[torch.nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    @staticmethod
    def _flat(tensors) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])

    def _update_mask(self, params) -> Optional[torch.Tensor]:
        """True where the flat vector's element may move: False over the
        parameters of the model's frozen top-level layers; None when
        nothing is frozen.  The same tensor while the frozen set and the
        parameters stay, so a captured step can keep reading it."""
        frozen = frozenset(getattr(self.model, "_frozen", None) or ())
        key = (frozen, tuple(id(p) for p in params))
        if key == self._mask_key:
            return self._mask
        mask = None
        if frozen:
            held = {id(p) for name in frozen
                    for p in self.model.subtree(name).parameters()}
            mask = torch.cat([torch.full((p.numel(),), id(p) not in held,
                                         dtype=torch.bool,
                                         device=self.device)
                              for p in params])
        self._mask_key, self._mask = key, mask
        return mask

    # ------------------------------------------------------------------
    # the forward and the train step
    # ------------------------------------------------------------------
    def _forward_fn(self) -> Callable:
        """The model's forward at ``compute_dtype``: over cast copies of
        every float parameter, float state leaf and float input,
        answering in f32; the model itself at f32.  The copies are taken
        now: call it again after the parameters change."""
        cd = self.compute_dtype
        if cd is None:
            return self.model
        cast = module_lib.cast_floats(self.model, cd)

        def run(*xs):
            xs = tuple(x.to(cd) if x.is_floating_point() else x for x in xs)
            return _to_f32(torch.func.functional_call(self.model, cast, xs))

        return run

    def _objective(self, xs, y):
        preds = self._forward_fn()(*xs)
        loss = self.loss_fn(y, preds)
        reg = getattr(self.model, "regularization_loss", None)
        if reg is not None:
            # the f32 masters, whatever the compute dtype
            penalty = reg()
            if isinstance(penalty, torch.Tensor) or penalty != 0.0:
                loss = loss + penalty
        return loss

    def _train_step(self, params, xs, y, mask, nan_scale) -> None:
        """One step: forward, backward, update — all queued on the device,
        no host read, every result written in place (the parameters, the
        optimizer state, the guard and the loss sums), so the step can be
        captured and replayed.  The update is scaled by ``lr_scale`` and
        zero where ``mask`` is False.  A non-finite loss keeps every
        parameter and every optimizer-state tensor as it was;
        ``nan_scale``, a device scalar, multiplies the loss: 1, or NaN for
        the ``estimator.step`` fault on a batch without float arrays.
        The new layer state is committed after the loss, where finite."""
        with module_lib.collect_state_updates() as layer_state:
            loss = self._objective(xs, y) * nan_scale
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        g = self._flat([gr if gr is not None else torch.zeros_like(p)
                        for gr, p in zip(grads, params)])
        p = self._flat(params)
        updates, new_state = self.tx.update(g, self.opt_state, p)
        updates = updates * self._lr_scale_t
        if mask is not None:
            updates = torch.where(mask, updates, 0.0)
        loss = loss.detach()
        ok = torch.isfinite(loss)
        with torch.no_grad():
            p_new = torch.where(ok, p + updates, p)
            torch._foreach_copy_(self.opt_state, [
                torch.where(ok, n, o)
                for n, o in zip(new_state, self.opt_state)])
            torch._foreach_copy_(params, [
                v.view_as(q) for v, q in zip(
                    torch.split(p_new, [q.numel() for q in params]),
                    params)])
            module_lib.commit_state(layer_state, ok)
            bad = (~ok).to(torch.int32)
            consec = (self._guard[1] + 1) * bad
            self._guard.copy_(torch.stack([
                self._guard[0] + bad, consec,
                torch.maximum(self._guard[2], consec)]))
            self._loss_acc.add_(torch.stack(
                [torch.where(ok, loss, torch.zeros_like(loss)),
                 ok.to(torch.float32)]))

    def _fresh_accumulators(self, saved=None):
        """Zero the epoch accumulators, or fill them with ``saved`` ones
        (a resume in the middle of an epoch), and the device copy of
        ``lr_scale``: in place, so a captured step keeps its tensors."""
        if self._loss_acc is None:
            self._loss_acc = torch.zeros(2, dtype=torch.float32,
                                         device=self.device)
            self._guard = torch.zeros(3, dtype=torch.int32,
                                      device=self.device)
            self._lr_scale_t = torch.ones((), dtype=torch.float32,
                                          device=self.device)
        if saved is None:
            self._loss_acc.zero_()
            self._guard.zero_()
        else:
            self._loss_acc.copy_(torch.as_tensor(np.asarray(saved[0]),
                                                 dtype=torch.float32))
            self._guard.copy_(torch.as_tensor(np.asarray(saved[1]),
                                              dtype=torch.int32))
        self._lr_scale_t.fill_(self._lr_scale)

    # ------------------------------------------------------------------
    # dispatch: one program per step, or per K steps
    # ------------------------------------------------------------------
    def _programs_for(self, params, mask) -> None:
        """Drop every step program when the tensors they would hold are
        no longer the live ones (called at each epoch's start)."""
        key = (tuple(p.data_ptr() for p in params),
               tuple(t.data_ptr() for t in self.opt_state),
               tuple(t.data_ptr() for t in _leaves(self.model.state())),
               None if mask is None else mask.data_ptr(),
               self._loss_acc.data_ptr(), self._guard.data_ptr(),
               self._lr_scale_t.data_ptr(), self._generators,
               self.compute_dtype, id(self.tx), id(self.loss_fn))
        if key != self._programs_key:
            self._programs.clear()
            self._programs_key = key

    def release_graphs(self) -> None:
        """Drop every captured program (training, evaluate, predict) and
        the memory pools their graphs hold; the weights and optimizer
        state stay, and the next ``fit`` / ``evaluate`` / ``predict``
        captures afresh.  A search that keeps each trial's model calls
        this for the trials that lost."""
        self._programs.clear()
        self._eval_programs.clear()
        self._feed = None
        self._pool = None
        self._eval_pool = None

    def _graph_pool(self, eval_pool: bool = False):
        """The step programs' shared graph memory pool, or with
        ``eval_pool`` the evaluate and predict programs' (None off the
        card)."""
        if self.device.type != "cuda":
            return None
        if eval_pool:
            if self._eval_pool is None:
                self._eval_pool = torch.cuda.graph_pool_handle()
            return self._eval_pool
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _resident_feed(self, arrays, perm, batch: int) -> _ResidentFeed:
        """The resident programs' feed over ``arrays`` (the live one when
        they are the same tensors) with ``perm`` copied in and the offset
        at 0; a new feed drops the programs of the old one."""
        n = int(perm.shape[0])
        feed = self._feed
        if feed is None or feed.key != _ResidentFeed.key_of(arrays, n,
                                                            batch):
            self._programs = {k: v for k, v in self._programs.items()
                              if k[0] != "resident"}
            feed = self._feed = _ResidentFeed(arrays, n, batch, self.device)
        feed.perm.copy_(perm)
        feed.offset.zero_()
        return feed

    def _dispatch(self, kind: str, feed, k: int, nan_loss: bool, params,
                  mask) -> None:
        """``k`` steps as one program launch.  ``kind`` "host": ``feed``
        is ``[inputs..., label]`` of ``k`` batches stacked along rows;
        "resident": ``feed`` is the epoch's ``_ResidentFeed``; "stream":
        a ``_StreamFeed`` of the shard's slot, ``k`` its steps."""
        if kind == "host":
            key = ("host", k) + tuple((tuple(t.shape), t.dtype)
                                      for t in feed)
        else:
            key = (kind, k) + feed.key
        prog = self._programs.get(key)
        if prog is None:
            prog = _StepProgram(self, kind, feed, k, params, mask)
            self._programs[key] = prog
        # the JAX package's kinds: a host dispatch of 1 or K steps, a
        # stream shard; and the port's resident K-step dispatch
        label = {"host": "K" if k > 1 else "1", "stream": "shard"}.get(
            kind, kind)
        parent = self._epoch_span or self._fit_span
        sp = (TRACER.start("train/step", trace=parent.trace,
                           parent=parent.sid, kind=label)
              if parent is not None else None)
        t0 = time.perf_counter()
        captures = prog.graph.captured
        prog.run(feed, nan_loss)
        if not captures and prog.graph.captured:
            obs.count("graph_captures_total", kind="train")
            obs.observe("graph_capture_seconds", prog.graph.capture_s,
                        kind="train")
        obs.observe("train_step_seconds", time.perf_counter() - t0,
                    kind=label)
        obs.count("train_steps_total", k, kind=label)
        if sp is not None:
            sp.end(steps=k)

    def _read_epoch(self):
        """The one host read of an epoch: (mean finite loss, bad steps,
        max consecutive bad steps)."""
        loss_sum, good, bad, _, max_consec = torch.cat(
            [self._loss_acc, self._guard.to(torch.float32)]).tolist()
        mean = loss_sum / good if good > 0 else float("nan")
        return mean, int(bad), int(max_consec)

    def _check_nan_guard(self, bad: int, max_consec: int,
                         steps: int) -> bool:
        """Epoch-boundary NaN policy, the JAX package's rules.  True when
        it rolled training back to the last checkpoint (the caller re-runs
        from ``finished_epochs``)."""
        cfg = self.ctx.config
        TIMERS.incr("robust/guard_check")
        if bad == 0:
            return False
        TIMERS.incr("robust/nan_steps", bad)
        logger.warning("%d/%d steps had a non-finite loss (max %d "
                       "consecutive); nan_policy=%s", bad, steps,
                       max_consec, cfg.nan_policy)
        if cfg.nan_policy == "raise":
            TIMERS.incr("robust/nan_raised")
            raise FloatingPointError(
                f"{bad} non-finite training step(s) in the last {steps} "
                f"(nan_policy=raise); the bad updates were skipped on the "
                f"device, params remain finite")
        TIMERS.incr("robust/nan_skipped", bad)
        if max_consec < cfg.max_bad_steps:
            return False
        if cfg.nan_policy == "rollback":
            if self._ckpt_mgr is not None:
                self._ckpt_mgr.wait(raise_errors=False)
            if (self._ckpt_mgr is None
                    or self._ckpt_mgr.latest_step() is None):
                raise FloatingPointError(
                    f"{max_consec} consecutive non-finite steps >= "
                    f"max_bad_steps={cfg.max_bad_steps} but no checkpoint "
                    "to roll back to (set_checkpoint first)")
            # back off from the live scale: the restore resets it to the
            # checkpoint's, and repeated rollbacks must compound
            backed_off = self._lr_scale * cfg.nan_backoff_factor
            TIMERS.incr("robust/nan_rollbacks")
            logger.warning(
                "rolling back to the last checkpoint after %d consecutive "
                "non-finite steps; learning-rate scale backed off to %.4g",
                max_consec, backed_off)
            self._restore_checkpoint()
            self._lr_scale = backed_off
            return True
        raise FloatingPointError(
            f"{max_consec} consecutive non-finite steps >= "
            f"max_bad_steps={cfg.max_bad_steps} under nan_policy=skip — "
            "training is making no progress")

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, x, y=None, batch_size: int = 32, epochs: int = 1,
            validation_data=None, end_trigger: Optional[Trigger] = None,
            shuffle: bool = True, verbose: bool = True,
            validation_trigger: Optional[Trigger] = None,
            validation_batch_size: Optional[int] = None,
            resume: bool = False):
        """Train until ``epochs`` epochs are finished in all (a second
        ``fit`` continues from ``finished_epochs``, as in the JAX package).

        ``x`` — an array or a list of arrays (numpy: host batches;
        tensors: device-resident), or a ``FeatureSet`` of ``(inputs...,
        label)``.  ``validation_data=(x, y)`` is evaluated at each epoch's
        end, or when ``validation_trigger`` fires.  ``resume`` continues
        from the newest intact checkpoint (``set_checkpoint``, else
        ``ZooConfig.checkpoint_dir``), and starts fresh when there is
        none.  A SIGTERM flushes a checkpoint and raises
        ``TrainingPreempted``.
        """
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet

        cfg = self.ctx.config
        if cfg.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}, "
                             f"got {cfg.nan_policy!r}")
        self._val_trigger = validation_trigger
        self._val_batch = validation_batch_size
        if not (resume and self._try_resume()):
            # a fit replays the configured shuffle stream from its seed
            self._host_rng = np.random.RandomState(cfg.seed)
            self._pending_resume = None
        self._preempt.clear()
        # the layers that draw from the fit's generator (Dropout,
        # GaussianSampler, the noise layers)
        dropouts = [m for m in self.model.modules()
                    if getattr(m, "draws_from_generator", False)]
        restore_sig = self._install_preempt_handler()
        # the fit's root span and metric mark: epoch and step spans chain
        # under it, and training_report() deltas the registry from the mark
        self._fit_metrics_mark = obs.METRICS.snapshot()
        self._fit_span = TRACER.start("train/fit", epochs=epochs,
                                      batch_size=batch_size)
        try:
            if isinstance(x, FeatureSet):
                out = self._fit_featureset(x, batch_size, epochs,
                                           validation_data, end_trigger,
                                           shuffle, verbose, dropouts)
            else:
                out = self._fit_arrays(x, y, batch_size, epochs,
                                       validation_data, end_trigger, shuffle,
                                       verbose, dropouts)
            self._fit_span.end(epochs_done=self.finished_epochs)
            return out
        except BaseException as e:
            if self._epoch_span is not None:
                self._epoch_span.end(status="error", error=str(e))
                self._epoch_span = None
            self._fit_span.end(status=type(e).__name__, error=str(e))
            raise
        finally:
            restore_sig()
            for m in dropouts:
                m.generator = None
            self.model.train(False)

    def _fit_arrays(self, x, y, batch_size, epochs, validation_data,
                    end_trigger, shuffle, verbose, dropouts):
        xs = _as_list(x)
        if y is None:
            raise ValueError("y is required for array training")
        resident = (all(isinstance(a, torch.Tensor) for a in xs)
                    and isinstance(y, torch.Tensor))
        n = int(xs[0].shape[0])
        steps = self._steps_per_epoch(n, batch_size)
        self._ensure_built(xs)
        if resident:
            self.last_data_path = "device_resident"
            self.last_data_path_reason = "tensor inputs"
            return self._fit_resident(
                [a.to(self.device) for a in xs], y.to(self.device),
                batch_size, steps, epochs, validation_data, end_trigger,
                shuffle, verbose, dropouts)
        self.last_data_path = "host_prefetch"
        self.last_data_path_reason = "host array inputs"
        arrays = [np.asarray(a) for a in xs] + [np.asarray(y)]
        pair = getattr(self.loss_fn, "batch_structured", False)
        depth = int(self.ctx.config.data_prefetch)
        stager = prefetch_lib.HostStager(self.device, slots=depth + 2)
        # K > 1: K batches gathered and copied as one chunk, run as one
        # K-step program (the same step sequence as K = 1)
        spans = _spans(steps, self._steps_per_execution())

        def prep(item):
            s0, s1, rows = item
            nan = self._step_fault(arrays)
            tensors, event = stager.stage(arrays, rows, nan=nan)
            return s0, s1, tensors, event, nan and not _has_float(arrays)

        def batches(epoch, start):
            """The epoch's batches from in-epoch step ``start`` on; its
            permutation is drawn from the host rng on the first one."""
            if not shuffle:
                perm = np.arange(n)
            elif pair:
                perm = _pair_perm(self._host_rng.permutation(n // 2), n)
            else:
                perm = self._host_rng.permutation(n)
            items = ((s0, s1, perm[s0 * batch_size:s1 * batch_size])
                     for s0, s1 in spans if s1 > start)
            it = prefetch_lib.prefetch(items, prep, depth=depth)
            try:
                for s0, s1, tensors, event, nan_loss in it:
                    stager.ready(event)
                    if start <= s0:
                        yield "host", tensors, s1 - s0, nan_loss
                        continue
                    # a resume inside a chunk: its other steps one by one
                    for s in range(start, s1):
                        off = (s - s0) * batch_size
                        yield ("host", [t[off:off + batch_size]
                                        for t in tensors], 1, nan_loss)
            finally:
                if hasattr(it, "close"):
                    it.close()

        return self._epochs(batches, steps, batch_size, epochs,
                            validation_data, end_trigger, verbose, dropouts,
                            mid_epoch=True)

    def _fit_resident(self, xs, y, batch_size, steps, epochs,
                      validation_data, end_trigger, shuffle, verbose,
                      dropouts):
        """Every epoch's permutation and every batch's gather on the
        device: no host-to-device bytes per batch, and one program launch
        per K steps (``_ResidentFeed``).  Resume and preemption act at
        epoch boundaries, as on the JAX package's one-dispatch resident
        epochs."""
        n = int(xs[0].shape[0])
        pair = getattr(self.loss_fn, "batch_structured", False)
        seed = self.ctx.config.seed
        spans = _spans(steps, self._steps_per_execution())

        def poisoned(arrays):
            """The epoch's arrays, float values NaN at the rows an
            ``estimator.resident_nan_rows`` fault names."""
            plan = faults.fire("estimator.resident_nan_rows")
            if plan is None or plan.action != "nan":
                return arrays
            rows = torch.as_tensor(plan.payload, device=self.device)
            out = []
            for a in arrays:
                if a.is_floating_point():
                    a = a.clone()
                    a[rows] = float("nan")
                out.append(a)
            return out

        def batches(epoch, start):
            arrays = poisoned(xs + [y])
            if shuffle:
                gen = torch.Generator(device=self.device).manual_seed(
                    seed + 7919 * epoch)
                perm = (_pair_perm(torch.randperm(n // 2, generator=gen,
                                                  device=self.device), n)
                        if pair else torch.randperm(n, generator=gen,
                                                    device=self.device))
            else:
                perm = torch.arange(n, device=self.device)
            feed = self._resident_feed(arrays, perm, batch_size)
            for s0, s1 in spans:
                yield "resident", feed, s1 - s0, False

        return self._epochs(batches, steps, batch_size, epochs,
                            validation_data, end_trigger, verbose, dropouts,
                            mid_epoch=False)

    def _resolve_data_path(self, fs, batch_size: int) -> Tuple[str, str]:
        """Which path a FeatureSet trains through, the JAX package's
        router: ``("device_resident" | "stream" | "host_prefetch",
        reason)`` by its cache level (else ``data_cache_level``) and
        ``data_device_budget_bytes``.  HOST → host batches; fits the
        budget → resident (a STREAM request that fits downgrades);
        larger, or sliced → the STREAM tier when a shard geometry exists
        (``plan_stream``), else host batches.  Each decision is counted
        in ``data_path_selected_total{path,reason}``."""
        from analytics_zoo_tpu_torch.data import streaming as stream_lib
        from analytics_zoo_tpu_torch.data.featureset import (
            CacheLevel, SlicedFeatureSet)

        def pick(path: str, code: str, reason: str) -> Tuple[str, str]:
            obs.count("data_path_selected_total", path=path, reason=code,
                      flat=f"estimator/data_path_{path}")
            return path, reason

        cfg = self.ctx.config
        self._stream_plan = None
        level = fs.cache_level or CacheLevel.normalize(cfg.data_cache_level)
        if level == CacheLevel.HOST:
            return pick("host_prefetch", "cache_level_host",
                        "cache level HOST")
        budget = int(cfg.data_device_budget_bytes)
        sliced = isinstance(fs, SlicedFeatureSet)
        if not sliced and fs.nbytes <= budget:
            return pick("device_resident", "fits_budget",
                        "fits device budget")
        plan, why = stream_lib.plan_stream(
            fs, budget, batch_size, slots=cfg.data_stream_slots,
            cache_dtype=cfg.data_cache_dtype)
        over = ("sliced (beyond-memory) featureset" if sliced else
                f"dataset {fs.nbytes}B over device budget {budget}B")
        if plan is None:
            logger.warning("%s and streaming is infeasible (%s); falling "
                           "back to host batches", over, why)
            return pick("host_prefetch", "stream_infeasible",
                        f"{over}; stream infeasible: {why}")
        logger.info(
            "STREAM tier engaged: %s; rotating %d shards of %d rows "
            "(%.1f MiB a shard on the device, %d slots%s)", over,
            plan.n_shards, plan.shard_rows, plan.device_shard_bytes / 2 ** 20,
            plan.slots, f", {plan.cache_dtype} device cache"
            if plan.cache_dtype else "")
        self._stream_plan = plan
        return pick("stream", "sliced" if sliced else "over_budget",
                    f"{over}; streaming {plan.n_shards} shards of "
                    f"{plan.shard_rows} rows")

    def _fit_featureset(self, fs, batch_size, epochs, validation_data,
                        end_trigger, shuffle, verbose, dropouts):
        path, reason = self._resolve_data_path(fs, batch_size)
        self.last_data_path, self.last_data_path_reason = path, reason
        if path == "device_resident":
            arrays = fs.device_arrays(self.device)
            if len(arrays) < 2:
                raise ValueError("training needs (inputs..., label) arrays")
            self._ensure_built(arrays[:-1])
            steps = self._steps_per_epoch(len(fs), batch_size)
            return self._fit_resident(arrays[:-1], arrays[-1], batch_size,
                                      steps, epochs, validation_data,
                                      end_trigger, shuffle, verbose,
                                      dropouts)
        if path == "stream":
            return self._fit_stream(fs, batch_size, epochs, validation_data,
                                    end_trigger, shuffle, verbose, dropouts)
        return self._fit_host_featureset(fs, batch_size, epochs,
                                         validation_data, end_trigger,
                                         shuffle, verbose, dropouts)

    def _fit_host_featureset(self, fs, batch_size, epochs, validation_data,
                             end_trigger, shuffle, verbose, dropouts):
        """Host batches from ``fs.batches``, K of them stacked into one
        copy and one K-step dispatch under ``steps_per_execution`` (an
        epoch's last ``steps % K`` one at a time), as in the JAX
        package.  A disk-backed set shuffles within windows of
        ``ZooConfig.shuffle_buffer`` rows."""
        cfg = self.ctx.config
        steps = self._steps_per_epoch(len(fs), batch_size)
        peek = next(iter(fs.batches(batch_size)))
        self._ensure_built(list(peek[:-1]))
        depth = int(cfg.data_prefetch)
        stager = prefetch_lib.HostStager(self.device, slots=depth + 2)
        k = self._steps_per_execution()
        shuffle_buffer = (cfg.shuffle_buffer if fs.memory_type != "DRAM"
                          else None)

        def chunked(it):
            """Groups of ``k`` batches, then the leftover one by one."""
            buf = []
            for b in it:
                buf.append(b)
                if len(buf) == k:
                    yield [np.concatenate([bb[j] for bb in buf])
                           for j in range(len(buf[0]))], k
                    buf = []
            for b in buf:
                yield list(b), 1

        def prep(item):
            batch, n_steps = item
            arrays = [np.asarray(a) for a in batch]
            nan = self._step_fault(arrays)
            tensors, event = stager.stage(arrays, np.arange(len(arrays[0])),
                                          nan=nan)
            return tensors, n_steps, event, nan and not _has_float(arrays)

        def batches(epoch, start):
            it = prefetch_lib.prefetch(
                chunked(fs.batches(batch_size, shuffle=shuffle,
                                   drop_remainder=True,
                                   shuffle_buffer=shuffle_buffer)),
                prep, depth=depth)
            try:
                for tensors, n_steps, event, nan_loss in it:
                    stager.ready(event)
                    yield "host", tensors, n_steps, nan_loss
            finally:
                if hasattr(it, "close"):
                    it.close()

        # the FeatureSet owns its shuffle stream, so resume acts at epoch
        # boundaries
        return self._epochs(batches, steps, batch_size, epochs,
                            validation_data, end_trigger, verbose, dropouts,
                            mid_epoch=False)

    def _stream_slots_for(self, plan):
        """The plan's device slots, kept across epochs and fits while its
        geometry holds (the shard programs hold their addresses); new
        slots drop the old slots' programs."""
        from analytics_zoo_tpu_torch.data.streaming import StreamSlots

        slots = self._stream_slots
        if slots is None or slots.key != plan.key + (plan.slots,):
            self._programs = {k: v for k, v in self._programs.items()
                              if k[0] != "stream"}
            self._stream_slots = slots = StreamSlots(plan, self.device)
        return slots

    def _fit_stream(self, fs, batch_size, epochs, validation_data,
                    end_trigger, shuffle, verbose, dropouts):
        """The STREAM tier: budget-sized shards rotate through device slots
        (``data/streaming.py``) while each shard trains as one program of
        ``steps_per_shard`` steps, captured once per slot and replayed for
        every shard and epoch.  An uploader failure finishes the epoch's
        remaining shards from host batches, each in the order the shard
        program would have gathered it, into the same accumulators (the
        epoch is never lost) and counts ``data_stream_fallbacks_total``;
        the next epoch starts a fresh uploader.  A preemption flushes the
        shard cursor (``shards_done * steps_per_shard`` in-epoch steps),
        and a resume re-derives the epoch's shard order from (seed, epoch)
        and restarts at that shard."""
        from analytics_zoo_tpu_torch.data import streaming as stream_lib

        cfg = self.ctx.config
        plan = self._stream_plan
        if plan is None:
            plan, why = stream_lib.plan_stream(
                fs, int(cfg.data_device_budget_bytes), batch_size,
                slots=cfg.data_stream_slots,
                cache_dtype=cfg.data_cache_dtype)
            if plan is None:
                raise ValueError(f"stream fit infeasible: {why}")
        self._ensure_built(plan.probe_inputs(fs))
        slots = self._stream_slots_for(plan)
        steps = plan.steps_per_shard
        pair = getattr(self.loss_fn, "batch_structured", False)
        depth = int(cfg.data_prefetch)
        stager = prefetch_lib.HostStager(self.device, slots=depth + 2)
        if self._val_trigger is not None:
            logger.warning("stream path dispatches whole shards; "
                           "validation_trigger is evaluated at shard "
                           "boundaries")

        def host_tail(order, first, perm_fn):
            """Shards ``order[first:]`` as host batches, one step each."""
            for pos in range(first, plan.n_shards):
                sid = int(order[pos])
                arrays = [np.asarray(a)[perm_fn(sid)]
                          for a in plan.load_shard(fs, sid)]
                for j in range(steps):
                    nan = self._step_fault(arrays)
                    tensors, event = stager.stage(
                        arrays, np.arange(j * plan.eff_batch,
                                          (j + 1) * plan.eff_batch),
                        nan=nan)
                    stager.ready(event)
                    yield "host", tensors, 1, nan and not _has_float(arrays)

        def batches(epoch, start):
            order = plan.epoch_order(cfg.seed, epoch, shuffle)

            def perm_fn(shard_id):
                return plan.shard_perm(cfg.seed, epoch, shard_id,
                                       shuffle=shuffle, pair_structured=pair)

            pos = min(start // steps, plan.n_shards)
            if pos:
                logger.info("stream resume: epoch %d restarts at shard "
                            "%d/%d", epoch + 1, pos, plan.n_shards)
            uploader = stream_lib.ShardUploader(fs, plan, order, slots,
                                                start=pos, perm_fn=perm_fn)
            wait_ms = 0.0
            try:
                while pos < plan.n_shards:
                    tw = time.perf_counter()
                    try:
                        lease = uploader.get()
                    except stream_lib.StreamUploadError as e:
                        obs.count("data_stream_fallbacks_total",
                                  reason="upload_error",
                                  flat="estimator/stream_fallbacks")
                        logger.warning(
                            "shard uploader failed mid-rotation (%s); "
                            "finishing epoch %d from host batches (%d/%d "
                            "shards remain)", e, epoch + 1,
                            plan.n_shards - pos, plan.n_shards)
                        uploader.close()
                        yield from host_tail(order, pos, perm_fn)
                        return
                    wait_ms += (time.perf_counter() - tw) * 1e3
                    lease.wait(self.device)
                    yield ("stream", _StreamFeed(slots, lease.slot,
                                                 plan.eff_batch), steps,
                           False)
                    lease.release(after=self._stream_event())
                    if plan.decode_bytes_per_shard:
                        obs.count("data_decode_bytes_total",
                                  plan.decode_bytes_per_shard,
                                  dtype=plan.cache_dtype,
                                  flat="stream/decode_bytes")
                    pos += 1
                # 1 - (time blocked on uploads / upload time): 1.0 when the
                # uploads hide behind the shard programs
                up = uploader.stats()["upload_ms_total"]
                obs.set_gauge("data_stream_overlap_frac",
                              1.0 if up <= 0 else min(
                                  1.0, max(0.0, 1.0 - wait_ms / up)),
                              flat="stream/overlap_frac")
            finally:
                uploader.close()

        return self._epochs(batches, plan.n_shards * steps, batch_size,
                            epochs, validation_data, end_trigger, verbose,
                            dropouts, mid_epoch=True)

    def _stream_event(self):
        """An event after the work queued so far on the current stream
        (None off the card): a released slot's overwrite waits on it."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _steps_per_execution(self) -> int:
        k = max(1, int(self.ctx.config.steps_per_execution))
        if k > 1 and self._val_trigger is not None:
            logger.warning(
                "steps_per_execution=%d: validation/trigger checks happen "
                "every K-th iteration (K-step chunks are one dispatch)", k)
        return k

    def _steps_per_epoch(self, n: int, batch_size: int) -> int:
        steps = n // batch_size
        if steps == 0:
            raise ValueError(f"dataset ({n}) smaller than batch "
                             f"({batch_size})")
        dropped = n - steps * batch_size
        if dropped:
            logger.warning(
                "dropping %d/%d samples per epoch (dataset not a multiple "
                "of batch %d); reshuffling each epoch varies which are "
                "dropped", dropped, n, batch_size)
        return steps

    @staticmethod
    def _step_fault(arrays) -> bool:
        """The ``estimator.step`` chaos hook, once per prepared batch: a
        planned exception raises (a pipeline failure); ``nan`` returns
        True (a numerical blow-up: NaN float arrays, or a NaN loss for a
        batch without float arrays)."""
        plan = faults.fire("estimator.step")
        if plan is None:
            return False
        if plan.exc is not None:
            raise plan.exc
        return plan.action == "nan"

    def _epochs(self, batches, steps, batch_size, epochs, validation_data,
                end_trigger, verbose, dropouts, mid_epoch):
        """The epoch loop shared by every data path: ``batches(epoch,
        start)`` yields, per dispatch, ``(kind, feed, k, nan_loss)`` —
        ``k`` steps of ``feed`` (see ``_dispatch``) and whether their loss
        is to be made NaN (a fault) — from in-epoch step ``start`` on
        (always 0 unless ``mid_epoch``: the path can resume inside an
        epoch).  Preemption, the NaN policy's rollback, checkpoints and
        the failure retry from the last checkpoint live here; they act
        between dispatches."""
        cfg = self.ctx.config
        retry = RetryPolicy.from_config(
            cfg, max_attempts=cfg.failure_retry_times,
            window_s=cfg.failure_retry_interval_s,
            name="estimator_fit").state()
        if not mid_epoch and self._pending_resume is not None:
            if self._pending_resume[1] > 0:
                logger.warning("the %s path resumes at epoch boundaries; "
                               "dropping the mid-epoch resume marker",
                               self.last_data_path)
            self._pending_resume = None
        epoch = self.finished_epochs
        while epoch < epochs:
            it = None
            try:
                t0 = time.time()
                self._epoch_span = TRACER.start(
                    "train/epoch", trace=self._fit_span.trace,
                    parent=self._fit_span.sid, epoch=epoch + 1)
                start, saved = 0, None
                pending, self._pending_resume = self._pending_resume, None
                if pending is not None and pending[0] == epoch:
                    # rewind the host rng to the interrupted epoch's start
                    # so its permutation is redrawn, then skip the steps
                    # already trained
                    _, start, rng_state, saved = pending
                    if rng_state is not None:
                        self._host_rng.set_state(rng_state)
                    if start:
                        logger.info("resuming epoch %d at in-epoch step %d",
                                    epoch + 1, start)
                epoch_rng_state = self._host_rng.get_state()
                self._fresh_accumulators(saved if start else None)
                if not mid_epoch:
                    self._maybe_preempt(epoch, 0, epoch_rng_state)
                self.model.train(True)
                for m in dropouts:
                    m.generator = self._dropout_gen
                self._generators = ((self._dropout_gen,) if dropouts
                                    else ())
                params = self._trainable()
                mask = self._update_mask(params)
                self._programs_for(params, mask)
                done = start
                it = batches(epoch, start)
                for kind, feed, k, nan_loss in it:
                    if mid_epoch:
                        # before the dispatch: a flush never marks a
                        # finished epoch as interrupted
                        self._maybe_preempt(epoch, done, epoch_rng_state)
                    self._dispatch(kind, feed, k, nan_loss, params, mask)
                    done += k
                    self.global_step += k
                    self._maybe_midepoch_validation(validation_data,
                                                    epoch + 1, batch_size)
                mean_loss, bad, max_consec = self._read_epoch()
                if self._check_nan_guard(bad, max_consec, done - start):
                    self._epoch_span.end(status="rollback")
                    self._epoch_span = None
                    epoch = self.finished_epochs        # rolled back
                    continue
                epoch += 1
                self.finished_epochs = epoch
                dt = time.time() - t0
                self._epoch_span.end(loss=mean_loss)
                self._epoch_span = None
                if self._epoch_end(epoch, mean_loss, dt,
                                   (done - start) * batch_size,
                                   validation_data,
                                   batch_size, verbose, end_trigger):
                    break
            except (KeyboardInterrupt, TrainingPreempted,
                    FloatingPointError):
                # preemption and the NaN policy's raise surface, never
                # retried
                if it is not None:
                    it.close()
                raise
            except Exception as e:
                if it is not None:
                    it.close()
                if self._epoch_span is not None:
                    self._epoch_span.end(status="retry", error=str(e))
                    self._epoch_span = None
                if self._ckpt_mgr is not None:
                    # land an in-flight write so the retry sees it
                    self._ckpt_mgr.wait(raise_errors=False)
                if (self._ckpt_mgr is None
                        or self._ckpt_mgr.latest_step() is None
                        or not retry.record_failure()):
                    raise
                logger.warning("step failed (%s); retry %s from checkpoint",
                               e, retry.describe())
                retry.backoff()
                self._restore_checkpoint()
                epoch = self.finished_epochs
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.wait()
        return self.history

    def _epoch_end(self, epoch, mean_loss, dt, rows, validation_data,
                   batch_size, verbose, end_trigger) -> bool:
        """History row, validation, checkpoint trigger; True when
        ``end_trigger`` fired."""
        rec = {"epoch": epoch, "loss": mean_loss, "throughput": rows / dt}
        obs.observe("train_epoch_seconds", dt)
        obs.set_gauge("train_loss", mean_loss)
        obs.set_gauge("train_throughput_rows_per_s", rec["throughput"])
        tstate = TriggerState(epoch=epoch, iteration=self.global_step,
                              epoch_finished=True, loss=mean_loss)
        if validation_data is not None and (
                self._val_trigger is None or self._val_trigger(tstate)):
            val = (self._last_val_result
                   if self._last_val_iter == self.global_step else
                   self.evaluate(validation_data[0], validation_data[1],
                                 batch_size=self._val_batch or batch_size))
            rec.update({f"val_{k}": v for k, v in val.items()})
            tstate.score = val.get(
                self.metrics[0].name if self.metrics else "loss")
        self.history.append(rec)
        self._write_scalars(rec, "epoch")
        if verbose:
            logger.info("epoch %d: %s", epoch,
                        {k: v for k, v in rec.items() if k != "epoch"})
        if self._ckpt_mgr is not None and self._ckpt_trigger(tstate):
            self._save_checkpoint()
        if self._flight_recorder is not None:
            self._flight_recorder.check()
        return end_trigger is not None and end_trigger(tstate)

    def _write_scalars(self, rec: Dict[str, float], skip: str) -> None:
        """A history row's values (all but its ``skip`` key) at the global
        step, into the TensorBoard writer when there is one."""
        if self._tb_writer is None:
            return
        for k, v in rec.items():
            if k != skip:
                self._tb_writer.add_scalar(k, v, self.global_step)
        self._tb_writer.flush()

    def _maybe_midepoch_validation(self, validation_data, epoch: int,
                                   batch_size: int) -> None:
        """Validation when a ``validation_trigger`` (e.g.
        SeveralIteration) fires between epoch boundaries."""
        if validation_data is None or self._val_trigger is None:
            return
        tstate = TriggerState(epoch=epoch, iteration=self.global_step,
                              epoch_finished=False)
        if not self._val_trigger(tstate):
            return
        self._last_val_iter = self.global_step
        val = self.evaluate(validation_data[0], validation_data[1],
                            batch_size=self._val_batch or batch_size)
        self._last_val_result = val
        self.model.train(True)
        rec = {"iteration": self.global_step}
        rec.update({f"val_{k}": v for k, v in val.items()})
        self.history.append(rec)
        self._write_scalars(rec, "iteration")

    # ------------------------------------------------------------------
    # preemption and resume
    # ------------------------------------------------------------------
    def _try_resume(self) -> bool:
        """``fit(resume=True)``: arm a restore of the newest intact
        checkpoint (made once the model is built); with none, a fresh
        start, never an error, so one command line serves the first
        attempt and every restart."""
        cfg = self.ctx.config
        if self._ckpt_mgr is None and cfg.checkpoint_dir:
            self.set_checkpoint(cfg.checkpoint_dir)
        if self._ckpt_mgr is None or self._ckpt_mgr.latest_step() is None:
            logger.info("fit(resume=True): no checkpoint found; "
                        "starting fresh")
            return False
        self._restore_pending = True
        TIMERS.incr("robust/auto_resume")
        return True

    def _install_preempt_handler(self) -> Callable[[], None]:
        """SIGTERM → a final synchronous checkpoint at the next step
        boundary.  Returns a callable restoring the previous handler.  A
        no-op off the main thread, where ``signal.signal`` would raise."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def _on_sigterm(signum, frame):
            logger.warning("SIGTERM received: flushing a final checkpoint "
                           "at the next step boundary")
            self._preempt.set()

        try:
            prev = signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            return lambda: None
        self._sigterm_handled = True

        def restore():
            self._sigterm_handled = False
            try:
                signal.signal(signal.SIGTERM, prev)
            except (ValueError, OSError, TypeError):
                pass

        return restore

    def _maybe_preempt(self, epoch: int, in_epoch_step: int,
                       epoch_rng_state) -> None:
        """The per-step preemption check.  An ``estimator.preempt`` fault
        requests one; its ``sigterm`` action sends the real signal to this
        process, through the handler ``fit`` installed."""
        plan = faults.fire("estimator.preempt")
        if plan is not None:
            if plan.action == "sigterm" and self._sigterm_handled:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                self._preempt.set()
        if not self._preempt.is_set():
            return
        step = self.global_step
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.save(step, self._snapshot(
                resume_epoch=epoch, in_epoch_step=in_epoch_step,
                epoch_rng_state=epoch_rng_state))
            TIMERS.incr("robust/preempt_flush")
            logger.warning(
                "preempted at global step %d (epoch %d, in-epoch step %d): "
                "final synchronous checkpoint flushed; fit(resume=True) "
                "continues here", step, epoch + 1, in_epoch_step)
        else:
            logger.warning("preempted at global step %d with no checkpoint "
                           "manager set; training state is lost", step)
        raise TrainingPreempted(
            f"training preempted at global step {step}", step=step)

    # ------------------------------------------------------------------
    # checkpoint plumbing
    # ------------------------------------------------------------------
    def _snapshot(self, resume_epoch: Optional[int] = None,
                  in_epoch_step: int = 0, epoch_rng_state=None):
        """The full training state over the live tensors (the manager
        copies them off): the JAX tree of parameters, the flat optimizer
        state, and the resume manifest.  ``epoch_rng`` is the host rng at
        the start of the (possibly interrupted) epoch, so a mid-epoch
        resume redraws its permutation; ``torch_rng`` the dropout
        generator's state at the same step boundary."""
        if epoch_rng_state is None:
            epoch_rng_state = self._host_rng.get_state()
        meta = {"global_step": np.asarray(self.global_step),
                "finished_epochs": np.asarray(self.finished_epochs),
                "lr_scale": np.asarray(self._lr_scale, np.float32),
                "resume_epoch": np.asarray(
                    self.finished_epochs if resume_epoch is None
                    else resume_epoch),
                "in_epoch_step": np.asarray(in_epoch_step),
                "data_path": np.asarray(self.last_data_path or "unset"),
                "host_rng": _pickled(self._host_rng.get_state()),
                "epoch_rng": _pickled(epoch_rng_state),
                "torch_rng": self._dropout_gen.get_state()}
        if in_epoch_step:
            meta["loss_acc"] = self._loss_acc
            meta["guard"] = self._guard
        return {"params": self.model.params(), "state": self.model.state(),
                "opt_state": list(self.opt_state), "meta": meta}

    def _save_checkpoint(self):
        if self.ctx.config.async_checkpoint:
            path = self._ckpt_mgr.save_async(self.global_step,
                                             self._snapshot())
        else:
            path = self._ckpt_mgr.save(self.global_step, self._snapshot())
        logger.info("checkpoint saved: %s", path)

    def _restore_checkpoint(self):
        """The newest intact snapshot into the live model, optimizer
        state, counters and generators (the model must be built)."""
        from analytics_zoo_tpu_torch.convert import load_archive_params

        step, tree = self._ckpt_mgr.restore()
        opt = [torch.from_numpy(np.asarray(a)) for a in tree["opt_state"]]
        numel = sum(p.numel() for p in self._trainable())
        if len(opt) != len(self.opt_state) or any(
                a.shape != b.shape for a, b in zip(opt, self.opt_state)):
            raise ValueError(
                f"checkpoint step {step} holds an optimizer state of "
                f"{[tuple(a.shape) for a in opt]}, not this estimator's "
                f"({numel} trainable parameters)")
        # into the live tensors, which captured steps hold
        load_archive_params(self.model, tree["params"], tree.get("state"))
        self.model.to(self.device)
        with torch.no_grad():
            for live, saved in zip(self.opt_state, opt):
                live.copy_(saved)
        meta = tree["meta"]
        self.global_step = int(meta["global_step"])
        self.finished_epochs = int(meta["finished_epochs"])
        self._lr_scale = float(meta.get("lr_scale", 1.0))
        host = _unpickled(meta, "host_rng")
        if host is not None:
            self._host_rng = np.random.RandomState()
            self._host_rng.set_state(host)
        if "torch_rng" in meta:
            self._dropout_gen.set_state(torch.from_numpy(
                np.asarray(meta["torch_rng"], np.uint8)))
        # the resume manifest, armed whenever an epoch-start rng state was
        # recorded: a flush on an epoch's first step comes after its
        # permutation was drawn, so the restart must rewind even at step 0
        r_step = int(meta.get("in_epoch_step", 0))
        rng_state = _unpickled(meta, "epoch_rng")
        saved = ((meta["loss_acc"], meta["guard"])
                 if "loss_acc" in meta else None)
        self._pending_resume = None
        if r_step > 0 or rng_state is not None:
            r_epoch = int(meta.get("resume_epoch", self.finished_epochs))
            self._pending_resume = (r_epoch, r_step, rng_state, saved)
        logger.info("restored checkpoint step %d", step)

    # ------------------------------------------------------------------
    # evaluate / predict
    # ------------------------------------------------------------------
    def _eval_forward(self, xs):
        """The inference forward at ``compute_dtype``, answering in f32."""
        return self._forward_fn()(*xs)

    def _eval_stats(self, xs, y, mask) -> List[torch.Tensor]:
        """One padded batch's statistics, flat: the loss sum and its unit
        count, then each metric's values in ``_metric_keys`` order.  The
        JAX eval step's rules: a per-row loss is summed under the mask; a
        loss that couples rows and takes a mask (``rank_hinge``) weighs
        by its own unit count (pairs); one that couples rows and takes no
        mask runs on the whole batch, weighed by the real rows.  Records
        each metric's statistic names for ``evaluate``'s finalize."""
        preds = self._eval_forward(xs)
        fn = self.loss_fn
        if getattr(fn, "batch_structured", False):
            if getattr(fn, "supports_mask", False):
                count = (fn.mask_count(mask)
                         if getattr(fn, "mask_count", None)
                         else torch.sum(mask))
                loss_sum = fn(y, preds, mask=mask) * count
            else:
                count = torch.sum(mask)
                loss_sum = fn(y, preds) * count
        else:
            def row(yt, yp):
                return fn(*torch.utils._pytree.tree_map(
                    lambda t: t[None], (yt, yp)))

            per = torch.func.vmap(row)(y, preds)
            loss_sum = torch.sum(per * mask)
            count = torch.sum(mask)
        out = [loss_sum, count]
        keys = []
        for m in self.metrics:
            stats = m.update(y, preds, mask)
            keys.append(sorted(stats))
            out.extend(stats[k] for k in keys[-1])
        self._eval_metric_keys = keys
        return out

    def _eval_program(self, kind: str, specs, batch: int) -> _EvalProgram:
        """The ``kind`` program of this signature, kept while the tensors
        it reads (parameters, layer state) and what it computes (compute
        dtype, loss, metrics) stay the same."""
        key = (tuple(p.data_ptr() for p in self.model.parameters()),
               tuple(t.data_ptr() for t in _leaves(self.model.state())),
               self.compute_dtype, id(self.loss_fn),
               tuple(id(m) for m in self.metrics))
        if key != self._eval_key:
            self._eval_programs.clear()
            self._eval_key = key
        sig = (kind, batch) + tuple((tuple(s), d) for s, d in specs)
        prog = self._eval_programs.get(sig)
        if prog is None:
            prog = _EvalProgram(self, kind, specs, batch)
            self._eval_programs[sig] = prog
        return prog

    def _run_eval_program(self, prog: _EvalProgram, kind: str, tensors):
        captures = prog.graph.captured
        out = prog.run(tensors)
        if not captures and prog.graph.captured:
            obs.count("graph_captures_total", kind=kind)
            obs.observe("graph_capture_seconds", prog.graph.capture_s,
                        kind=kind)
        obs.count("eval_batches_total", kind=kind)
        return out

    @staticmethod
    def _padded(a, sl: slice, batch: int):
        """Rows ``sl`` of ``a`` padded with zero rows to ``batch`` rows (a
        tensor on ``a``'s device, or a CPU tensor over host rows)."""
        if isinstance(a, torch.Tensor):
            rows = a[sl]
            if rows.shape[0] == batch:
                return rows
            return torch.cat([rows, rows.new_zeros(
                (batch - rows.shape[0],) + tuple(rows.shape[1:]))])
        rows = np.asarray(a[sl])
        if rows.shape[0] < batch:
            rows = np.concatenate([rows, np.zeros(
                (batch - rows.shape[0],) + rows.shape[1:], rows.dtype)])
        return torch.from_numpy(np.ascontiguousarray(rows))

    @staticmethod
    def _spec(a) -> tuple:
        """(row shape, torch dtype) of an array or tensor."""
        if isinstance(a, torch.Tensor):
            return tuple(a.shape[1:]), a.dtype
        a = np.asarray(a)
        return tuple(a.shape[1:]), torch.from_numpy(a[:0]).dtype

    def evaluate(self, x, y=None, batch_size: int = 32) -> Dict[str, float]:
        """Loss and metrics over every row: each batch padded to
        ``batch_size`` rows and masked (one program per signature, a CUDA
        graph on the card), statistics summed on the device and read back
        once."""
        xs = _as_list(x)
        self._ensure_built(xs)
        n = int(xs[0].shape[0])
        self.model.train(False)
        specs = [self._spec(a) for a in xs + [y]] + [((), torch.float32)]
        prog = self._eval_program("eval", specs, batch_size)
        for t in prog.acc:
            t.zero_()
        mask = np.ones(batch_size, np.float32)
        for s in range(int(math.ceil(n / batch_size))):
            sl = slice(s * batch_size, min((s + 1) * batch_size, n))
            mask[sl.stop - sl.start:] = 0.0
            self._run_eval_program(prog, "eval", [
                self._padded(a, sl, batch_size) for a in xs + [y]]
                + [torch.from_numpy(mask)])
        loss_sum, count, *rest = prog.acc
        out = {"loss": loss_sum / count}
        for m, keys in zip(self.metrics, self._eval_metric_keys):
            out[m.name] = m.finalize(dict(zip(keys, rest[:len(keys)])))
            rest = rest[len(keys):]
        with torch.no_grad():
            vals = torch.stack([v.to(torch.float32).reshape(())
                                for v in out.values()]).tolist()
        return dict(zip(out, vals))

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        return self.predict_raw(x, batch_size=batch_size)[0]

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        """Class indices from the model's scores; 1-based when
        ``zero_based_label=False``."""
        scores = np.asarray(self.predict(x, batch_size=batch_size))
        if scores.ndim == 1 or scores.shape[-1] == 1:
            cls = (scores.reshape(len(scores)) > 0.5).astype(np.int64)
        else:
            cls = np.argmax(scores, axis=-1).astype(np.int64)
        return cls if zero_based_label else cls + 1

    def predict_raw(self, x, batch_size: int = 32) -> List[np.ndarray]:
        """One host array per model output (a 1-list for single-output
        models): each batch padded to ``batch_size`` rows through one
        predict program per signature (a CUDA graph on the card), its real
        rows read back per batch, which bounds device memory for any
        ``n``."""
        xs = _as_list(x)
        self._ensure_built(xs)
        n = int(xs[0].shape[0])
        self.model.train(False)
        prog = self._eval_program("predict", [self._spec(a) for a in xs],
                                  batch_size)
        outs: Optional[List[List[np.ndarray]]] = None
        for s in range(int(math.ceil(n / batch_size))):
            sl = slice(s * batch_size, min((s + 1) * batch_size, n))
            preds = self._run_eval_program(
                prog, "predict", [self._padded(a, sl, batch_size)
                                  for a in xs])
            if not isinstance(preds, (list, tuple)):
                preds = [preds]
            if outs is None:
                outs = [[] for _ in preds]
            for o, p in zip(outs, preds):
                o.append(p[:sl.stop - sl.start].float().cpu().numpy())
        return [np.concatenate(o, axis=0) for o in outs]
