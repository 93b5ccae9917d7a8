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
  ``np.random.RandomState(ZooConfig.seed)``, reset at every ``fit``, so
  the port replays the JAX package's batches exactly.  The last partial
  batch is dropped, with a warning.
- **Data paths** (``last_data_path``): host numpy arrays are gathered per
  batch on the host and copied to the device (``host_prefetch``); tensors
  are moved to the device once and every epoch's permutation and gathers
  run there (``device_resident``); a ``FeatureSet`` takes one of the two
  by its cache level and ``ZooConfig.data_device_budget_bytes``.
- **NaN/Inf guard.** A step whose loss is not finite leaves the
  parameters and the optimizer state as they were (``torch.where`` on
  the device) and is counted; ``ZooConfig.nan_policy`` is applied at the
  epoch boundary.  The epoch loss is the mean over the finite steps.
- **No per-step host reads.** The guard's counters and the loss sums
  stay on the device and are read back once per epoch.

Checkpoints, resume, TensorBoard, the stream tier, gradient accumulation,
mixed precision and multi-GPU are not ported yet.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.context import (ZooContext, get_zoo_context,
                                                  resolve_device)
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.core.triggers import Trigger, TriggerState
from analytics_zoo_tpu_torch.nn import metrics as metrics_lib
from analytics_zoo_tpu_torch.nn import objectives
from analytics_zoo_tpu_torch.train import optimizers as optim_lib

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


class Estimator:
    """fit / evaluate / predict over a ``KerasNet`` on one device.

    ``device`` defaults to the context's, else ``cuda`` (raising when
    there is none); pass ``device="cpu"`` to train on the CPU.
    """

    def __init__(self, model, optimizer="adam", loss="mse",
                 metrics: Optional[Sequence] = None,
                 ctx: Optional[ZooContext] = None,
                 grad_clip_norm: Optional[float] = None,
                 grad_clip_value: Optional[float] = None,
                 device=None):
        self.model = model
        tx = optim_lib.get(optimizer)
        if grad_clip_norm is not None:
            tx = optim_lib.chain(optim_lib.clip_by_global_norm(grad_clip_norm),
                                 tx)
        elif grad_clip_value is not None:
            tx = optim_lib.chain(optim_lib.clip(grad_clip_value), tx)
        self.tx = tx
        self.loss_fn = objectives.get(loss)
        self.metrics = [metrics_lib.get(m) for m in (metrics or [])]
        self.ctx = ctx or get_zoo_context()
        self.device = resolve_device(device)

        self.opt_state: Optional[List[torch.Tensor]] = None
        self.global_step = 0
        self.finished_epochs = 0
        self.history: List[Dict[str, float]] = []
        # which input path the last fit() ran ("device_resident" or
        # "host_prefetch") and why
        self.last_data_path: Optional[str] = None
        self.last_data_path_reason: Optional[str] = None

        self._initial_weights = None
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

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def set_initial_weights(self, params, state=None):
        """Weights applied by layer name at the first build instead of the
        random ones (applied at once, with a fresh optimizer state, when
        already built).  ``params`` is the JAX layout
        ``{layer: {leaf: array}}``; ``state`` is accepted for the JAX
        signature (the port's layers keep no state)."""
        self._initial_weights = params
        if self._built:
            self._load_initial()
            self._init_opt_state()
        return self

    def _load_initial(self):
        from analytics_zoo_tpu_torch.convert import load_jax_params

        given, self._initial_weights = self._initial_weights, None
        current = self.model.params()
        missing = sorted(set(current) - set(given))
        if missing:
            logger.warning("initial weights cover %d/%d layers; these keep "
                           "their RANDOM init: %s",
                           len(current) - len(missing), len(current),
                           missing)
        load_jax_params(self.model, {k: given.get(k, v)
                                     for k, v in current.items()})
        self.model.to(self.device)

    def _ensure_built(self, inputs):
        if not self._built:
            if getattr(self.model, "_output_shape", None) is None:
                shapes = [(2,) + tuple(x.shape[1:]) for x in inputs]
                self.model.build(torch.Generator().manual_seed(
                    self.ctx.config.seed), *shapes)
            self.model.to(self.device)
            if self._initial_weights is not None:
                self._load_initial()
            self._dropout_gen = torch.Generator(
                device=self.device).manual_seed(self.ctx.config.seed)
            self._built = True
        self.model.to(self.device)
        numel = sum(p.numel() for p in self._trainable())
        if self.opt_state is None or self._state_numel != numel:
            self._init_opt_state()

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

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _objective(self, xs, y):
        preds = self.model(*xs)
        loss = self.loss_fn(y, preds)
        reg = getattr(self.model, "regularization_loss", None)
        if reg is not None:
            penalty = reg()
            if isinstance(penalty, torch.Tensor) or penalty != 0.0:
                loss = loss + penalty
        return loss

    def _train_step(self, params, xs, y) -> None:
        """One step: forward, backward, update — all queued on the device,
        no host read.  A non-finite loss keeps every parameter and every
        optimizer-state tensor as it was."""
        loss = self._objective(xs, y)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        g = self._flat([gr if gr is not None else torch.zeros_like(p)
                        for gr, p in zip(grads, params)])
        p = self._flat(params)
        updates, new_state = self.tx.update(g, self.opt_state, p)
        loss = loss.detach()
        ok = torch.isfinite(loss)
        p_new = torch.where(ok, p + updates, p)
        self.opt_state = [torch.where(ok, n, o)
                          for n, o in zip(new_state, self.opt_state)]
        with torch.no_grad():
            torch._foreach_copy_(params, [
                v.view_as(q) for v, q in zip(
                    torch.split(p_new, [q.numel() for q in params]),
                    params)])
        bad = (~ok).to(torch.int32)
        consec = (self._guard[1] + 1) * bad
        self._guard = torch.stack([self._guard[0] + bad, consec,
                                   torch.maximum(self._guard[2], consec)])
        self._loss_acc = self._loss_acc + torch.stack(
            [torch.where(ok, loss, torch.zeros_like(loss)),
             ok.to(torch.float32)])

    def _fresh_accumulators(self):
        self._loss_acc = torch.zeros(2, dtype=torch.float32,
                                     device=self.device)
        self._guard = torch.zeros(3, dtype=torch.int32, device=self.device)

    def _read_epoch(self):
        """The one host read of an epoch: (mean finite loss, bad steps,
        max consecutive bad steps)."""
        loss_sum, good, bad, _, max_consec = torch.cat(
            [self._loss_acc, self._guard.to(torch.float32)]).tolist()
        mean = loss_sum / good if good > 0 else float("nan")
        return mean, int(bad), int(max_consec)

    def _check_nan_guard(self, bad: int, max_consec: int,
                         steps: int) -> None:
        """Epoch-boundary NaN policy, the JAX package's rules."""
        cfg = self.ctx.config
        TIMERS.incr("robust/guard_check")
        if bad == 0:
            return
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
            return
        if cfg.nan_policy == "rollback":
            raise FloatingPointError(
                f"{max_consec} consecutive non-finite steps >= "
                f"max_bad_steps={cfg.max_bad_steps} but no checkpoint to "
                f"roll back to (checkpoints are not ported; the learning "
                f"rate would back off by {cfg.nan_backoff_factor})")
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
            validation_batch_size: Optional[int] = None):
        """Train until ``epochs`` epochs are finished in all (a second
        ``fit`` continues from ``finished_epochs``, as in the JAX package).

        ``x`` — an array or a list of arrays (numpy: host batches;
        tensors: device-resident), or a ``FeatureSet`` of ``(inputs...,
        label)``.  ``validation_data=(x, y)`` is evaluated at each epoch's
        end, or when ``validation_trigger`` fires.
        """
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet
        from analytics_zoo_tpu_torch.nn.layers.core import Dropout

        cfg = self.ctx.config
        if cfg.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}, "
                             f"got {cfg.nan_policy!r}")
        self._val_trigger = validation_trigger
        self._val_batch = validation_batch_size
        # a fit replays the configured shuffle stream from its seed
        self._host_rng = np.random.RandomState(cfg.seed)
        dropouts = [m for m in self.model.modules() if isinstance(m, Dropout)]
        try:
            if isinstance(x, FeatureSet):
                return self._fit_featureset(x, batch_size, epochs,
                                            validation_data, end_trigger,
                                            shuffle, verbose, dropouts)
            return self._fit_arrays(x, y, batch_size, epochs,
                                    validation_data, end_trigger, shuffle,
                                    verbose, dropouts)
        finally:
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
        xs = [np.asarray(a) for a in xs]
        y = np.asarray(y)
        pair = getattr(self.loss_fn, "batch_structured", False)
        k = max(1, int(self.ctx.config.steps_per_execution))
        n_chunks = steps // k if k > 1 else 0

        def batches(epoch):
            if not shuffle:
                perm = np.arange(n)
            elif pair:
                perm = _pair_perm(self._host_rng.permutation(n // 2), n)
            else:
                perm = self._host_rng.permutation(n)
            for c in range(n_chunks):
                rows = perm[c * k * batch_size:(c + 1) * k * batch_size]
                chunk = [self._to_device(a[rows]) for a in xs + [y]]
                for s in range(k):
                    yield [t[s * batch_size:(s + 1) * batch_size]
                           for t in chunk]
            for s in range(n_chunks * k, steps):
                rows = perm[s * batch_size:(s + 1) * batch_size]
                yield [self._to_device(a[rows]) for a in xs + [y]]

        return self._epochs(batches, steps, batch_size, epochs,
                            validation_data, end_trigger, verbose, dropouts)

    def _fit_resident(self, xs, y, batch_size, steps, epochs,
                      validation_data, end_trigger, shuffle, verbose,
                      dropouts):
        """Every epoch's permutation and every batch's gather on the
        device: no host-to-device bytes per batch."""
        n = int(xs[0].shape[0])
        pair = getattr(self.loss_fn, "batch_structured", False)
        seed = self.ctx.config.seed

        def batches(epoch):
            perm = None
            if shuffle:
                gen = torch.Generator(device=self.device).manual_seed(
                    seed + 7919 * epoch)
                perm = (_pair_perm(torch.randperm(n // 2, generator=gen,
                                                  device=self.device), n)
                        if pair else torch.randperm(n, generator=gen,
                                                    device=self.device))
            for s in range(steps):
                if perm is None:
                    yield [a[s * batch_size:(s + 1) * batch_size]
                           for a in xs + [y]]
                else:
                    idx = perm[s * batch_size:(s + 1) * batch_size]
                    yield [a.index_select(0, idx) for a in xs + [y]]

        return self._epochs(batches, steps, batch_size, epochs,
                            validation_data, end_trigger, verbose, dropouts)

    def _fit_featureset(self, fs, batch_size, epochs, validation_data,
                        end_trigger, shuffle, verbose, dropouts):
        from analytics_zoo_tpu_torch.data.featureset import CacheLevel

        cfg = self.ctx.config
        level = fs.cache_level or CacheLevel.normalize(cfg.data_cache_level)
        budget = int(cfg.data_device_budget_bytes)
        if level == CacheLevel.DEVICE and fs.nbytes <= budget:
            arrays = fs.device_arrays(self.device)
            if len(arrays) < 2:
                raise ValueError("training needs (inputs..., label) arrays")
            self._ensure_built(arrays[:-1])
            self.last_data_path = "device_resident"
            self.last_data_path_reason = "fits device budget"
            steps = self._steps_per_epoch(len(fs), batch_size)
            return self._fit_resident(arrays[:-1], arrays[-1], batch_size,
                                      steps, epochs, validation_data,
                                      end_trigger, shuffle, verbose,
                                      dropouts)
        self.last_data_path = "host_prefetch"
        if level == CacheLevel.HOST:
            self.last_data_path_reason = "cache level HOST"
        else:
            self.last_data_path_reason = (
                f"dataset {fs.nbytes}B over device budget {budget}B")
            logger.warning("%s; training from host batches (the stream "
                           "tier is not ported)", self.last_data_path_reason)
        steps = self._steps_per_epoch(len(fs), batch_size)
        peek = next(iter(fs.batches(batch_size)))
        self._ensure_built(list(peek[:-1]))

        def batches(epoch):
            for b in fs.batches(batch_size, shuffle=shuffle,
                                drop_remainder=True):
                yield [self._to_device(a) for a in b]

        return self._epochs(batches, steps, batch_size, epochs,
                            validation_data, end_trigger, verbose, dropouts)

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

    def _to_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _epochs(self, batches, steps, batch_size, epochs, validation_data,
                end_trigger, verbose, dropouts):
        """The epoch loop shared by every data path: ``batches(epoch)``
        yields one list ``[inputs..., label]`` of device tensors per
        step."""
        epoch = self.finished_epochs
        while epoch < epochs:
            t0 = time.time()
            self._fresh_accumulators()
            self.model.train(True)
            for m in dropouts:
                m.generator = self._dropout_gen
            params = self._trainable()
            done = 0
            for batch in batches(epoch):
                self._train_step(params, batch[:-1], batch[-1])
                done += 1
                self.global_step += 1
                self._maybe_midepoch_validation(validation_data, epoch + 1,
                                                batch_size)
            mean_loss, bad, max_consec = self._read_epoch()
            self._check_nan_guard(bad, max_consec, done)
            epoch += 1
            self.finished_epochs = epoch
            dt = time.time() - t0
            rec = {"epoch": epoch, "loss": mean_loss,
                   "throughput": steps * batch_size / dt}
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
            if verbose:
                logger.info("epoch %d: %s", epoch,
                            {k: v for k, v in rec.items() if k != "epoch"})
            if end_trigger is not None and end_trigger(tstate):
                break
        return self.history

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

    # ------------------------------------------------------------------
    # evaluate / predict
    # ------------------------------------------------------------------
    def _rows(self, a, sl) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a[sl].to(self.device)
        return self._to_device(np.asarray(a)[sl])

    def evaluate(self, x, y=None, batch_size: int = 32) -> Dict[str, float]:
        """Loss and metrics over every row (the last batch may be short);
        statistics sum on the device and are read back once."""
        xs = _as_list(x)
        self._ensure_built(xs)
        n = int(xs[0].shape[0])
        self.model.train(False)
        agg = None
        with torch.inference_mode():
            for s in range(int(math.ceil(n / batch_size))):
                sl = slice(s * batch_size, min((s + 1) * batch_size, n))
                preds = self.model(*[self._rows(a, sl) for a in xs])
                by = self._rows(y, sl)
                rows = sl.stop - sl.start
                stats = {"loss": {"sum": self.loss_fn(by, preds) * rows,
                                  "count": torch.full((), float(rows),
                                                      device=self.device)}}
                for m in self.metrics:
                    stats[m.name] = m.update(by, preds)
                agg = stats if agg is None else {
                    k: {j: agg[k][j] + v[j] for j in v}
                    for k, v in stats.items()}
            out = {"loss": agg["loss"]["sum"] / agg["loss"]["count"]}
            for m in self.metrics:
                out[m.name] = m.finalize(agg[m.name])
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
        models); each batch's predictions come back to the host, which
        bounds device memory for any ``n``."""
        xs = _as_list(x)
        self._ensure_built(xs)
        n = int(xs[0].shape[0])
        self.model.train(False)
        outs: Optional[List[List[np.ndarray]]] = None
        with torch.inference_mode():
            for s in range(int(math.ceil(n / batch_size))):
                sl = slice(s * batch_size, min((s + 1) * batch_size, n))
                preds = self.model(*[self._rows(a, sl) for a in xs])
                if not isinstance(preds, (list, tuple)):
                    preds = [preds]
                if outs is None:
                    outs = [[] for _ in preds]
                for o, p in zip(outs, preds):
                    o.append(p.float().cpu().numpy())
        return [np.concatenate(o, axis=0) for o in outs]
