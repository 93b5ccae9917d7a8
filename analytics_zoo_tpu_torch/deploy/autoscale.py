"""Metrics-driven autoscaler for the serving pipeline.

A control loop over the stage gauges the pipeline already publishes
(docs/OBSERVABILITY.md): decode-queue depth, executor inflight,
per-model observed e2e p99 vs its SLO, and replica health.  Each tick
(``Autoscaler.check`` — ridden by the serving supervisor at the
``serving_autoscale_interval_s`` cadence) it may move one of three
actuators on :class:`~analytics_zoo_tpu_torch.deploy.serving.ClusterServing`:

- **decode_workers** (``resize_decode_pool``): queue pressure grows the
  decode pool toward ``max_decode_workers``; a drained queue shrinks it.
- **replicas** (``resize_model_replicas``, per model): a model whose
  observed p99 crowds its SLO gets more replicas (HBM budget
  permitting); a model far under SLO with idle capacity gives them back.
- **batch_deadline** (``set_batch_deadline_ms``): sustained queue
  pressure *without* SLO pressure raises the batcher deadline (bigger
  fused batches, better device efficiency); SLO pressure lowers it
  (latency beats batching).

Two dampers keep the loop from flapping (docs/SERVING.md "Warm start &
multi-model" — hysteresis rules): a decision only fires after
``hysteresis`` CONSECUTIVE ticks agree on the same (model, resource,
direction), and each (model, resource) then enters a ``cooldown_s``
quiet period.  Every applied action is counted in
``serving_autoscale_actions_total{model,resource,direction}`` and kept
in the ``actions`` audit list the chaos soak asserts over.

The reference scaled by adding Spark executors to the ClusterServing
job (PAPER.md §L1); this is the in-process equivalent.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.observe import metrics as obs

__all__ = ["AutoscalePolicy", "Autoscaler", "audit_actions"]

logger = logging.getLogger("analytics_zoo_tpu_torch.deploy")

# model label for actions that concern the whole pipeline, not one model
PIPELINE = "_pipeline"
ALL_MODELS = "_all"


class AutoscalePolicy:
    """Bounds + watermarks for the control loop.  Defaults are sized
    for the single-host pipeline; the chaos soak and the bench override
    them to act fast."""

    def __init__(self,
                 min_decode_workers: int = 1,
                 max_decode_workers: int = 16,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 min_batch_delay_ms: float = 1.0,
                 max_batch_delay_ms: float = 50.0,
                 queue_high: int = 64,
                 queue_low: int = 2,
                 slo_high_frac: float = 1.0,
                 slo_low_frac: float = 0.3,
                 hysteresis: int = 2,
                 cooldown_s: float = 5.0):
        self.min_decode_workers = max(1, int(min_decode_workers))
        self.max_decode_workers = max(self.min_decode_workers,
                                      int(max_decode_workers))
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.min_batch_delay_ms = float(min_batch_delay_ms)
        self.max_batch_delay_ms = float(max_batch_delay_ms)
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        # replica pressure thresholds as fractions of the model's SLO:
        # p99 >= slo * high_frac -> grow; p99 <= slo * low_frac -> shrink
        self.slo_high_frac = float(slo_high_frac)
        self.slo_low_frac = float(slo_low_frac)
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown_s = float(cooldown_s)


class Autoscaler:
    """One instance per :class:`ClusterServing`; driven by its
    supervisor (``sup.add_check("autoscale", scaler.check, every=k)``)
    or directly by tests with fabricated signals."""

    def __init__(self, serving, policy: Optional[AutoscalePolicy] = None,
                 clock=time.monotonic):
        self.serving = serving
        self.policy = policy or AutoscalePolicy(
            cooldown_s=serving.cfg.autoscale_cooldown_s)
        self._clock = clock
        # (model, resource, direction) -> consecutive agreeing ticks
        self._streak: Dict[tuple, int] = {}
        # (model, resource) -> time of last applied action
        self._last: Dict[tuple, float] = {}
        self.actions: List[Dict[str, Any]] = []

    # -- signals -----------------------------------------------------------

    def signals(self) -> Dict[str, Any]:
        """One coherent snapshot of the gauges the loop decides from."""
        srv = self.serving
        ex = srv._executor
        decode_q = getattr(srv, "_decode_q", None)
        sig: Dict[str, Any] = {
            "queue_depth": decode_q.qsize() if decode_q is not None else 0,
            "inflight": ex.inflight if ex is not None else 0,
            "max_inflight": srv.cfg.max_inflight,
            "decode_workers": srv._decode_target,
            "models": {},
        }
        for m in srv.models:
            sig["models"][m] = {
                "replicas": ex.group_size(m) if ex is not None else 0,
                "healthy": ex.healthy_replicas(m) if ex is not None else 0,
                "slo_ms": srv.cfg.slo_for(m),
                "p99_ms": srv._admission.p99(m),
            }
        return sig

    # -- dampers -----------------------------------------------------------

    def _breach(self, key: tuple, breached: bool) -> bool:
        """Consecutive-tick hysteresis: True only once the same (model,
        resource, direction) has been signalled ``hysteresis`` ticks in
        a row.  A tick that doesn't signal resets the streak."""
        if not breached:
            self._streak.pop(key, None)
            return False
        n = self._streak.get(key, 0) + 1
        self._streak[key] = n
        return n >= self.policy.hysteresis

    def _cooled(self, model: str, resource: str) -> bool:
        t = self._last.get((model, resource))
        return t is None or self._clock() - t >= self.policy.cooldown_s

    def _act(self, model: str, resource: str, direction: str,
             apply_fn, detail: str) -> None:
        value = apply_fn()
        self._last[(model, resource)] = self._clock()
        self._streak.pop((model, resource, direction), None)
        obs.count("serving_autoscale_actions_total", model=model,
                  resource=resource, direction=direction,
                  flat=f"serving/autoscale_{resource}_{direction}")
        self.actions.append({"t": self._clock(), "model": model,
                             "resource": resource, "direction": direction,
                             "value": value, "detail": detail})
        logger.info("autoscale: %s %s %s -> %s (%s)", model, resource,
                    direction, value, detail)

    # -- the control loop --------------------------------------------------

    def check(self, signals: Optional[Dict[str, Any]] = None) -> None:
        """One control tick.  Tests pass fabricated ``signals``; the
        supervisor passes none and the live gauges are read."""
        sig = signals if signals is not None else self.signals()
        self._scale_decode(sig)
        for m in list(sig["models"]):
            self._scale_replicas(m, sig)
        self._scale_deadline(sig)

    def _scale_decode(self, sig: Dict[str, Any]) -> None:
        pol = self.policy
        cur = sig["decode_workers"]
        depth = sig["queue_depth"]
        up = depth >= pol.queue_high and cur < pol.max_decode_workers
        down = depth <= pol.queue_low and cur > pol.min_decode_workers
        if self._breach((PIPELINE, "decode_workers", "up"), up) \
                and self._cooled(PIPELINE, "decode_workers"):
            n = min(pol.max_decode_workers, max(cur + 1, cur * 2))
            self._act(PIPELINE, "decode_workers", "up",
                      lambda: self.serving.resize_decode_pool(n),
                      f"queue depth {depth} >= {pol.queue_high}")
        elif self._breach((PIPELINE, "decode_workers", "down"), down) \
                and self._cooled(PIPELINE, "decode_workers"):
            n = max(pol.min_decode_workers, cur - 1)
            self._act(PIPELINE, "decode_workers", "down",
                      lambda: self.serving.resize_decode_pool(n),
                      f"queue depth {depth} <= {pol.queue_low}")

    def _scale_replicas(self, model: str, sig: Dict[str, Any]) -> None:
        pol = self.policy
        ms = sig["models"][model]
        cur = ms["replicas"]
        slo, p99 = ms["slo_ms"], ms["p99_ms"]
        if slo > 0 and p99 > 0:
            up = (p99 >= slo * pol.slo_high_frac
                  and cur < pol.max_replicas)
            down = (p99 <= slo * pol.slo_low_frac
                    and cur > pol.min_replicas)
            why_up = f"p99 {p99:.0f}ms >= SLO {slo:.0f}ms"
            why_down = f"p99 {p99:.0f}ms << SLO {slo:.0f}ms"
        else:
            # no SLO for this model: fall back to saturation signals —
            # the executor pegged at max_inflight with a deep queue
            saturated = (sig["inflight"] >= sig["max_inflight"]
                         and sig["queue_depth"] >= pol.queue_high)
            up = saturated and cur < pol.max_replicas
            down = (sig["queue_depth"] <= pol.queue_low
                    and sig["inflight"] == 0 and cur > pol.min_replicas)
            why_up = (f"saturated (inflight {sig['inflight']}, "
                      f"queue {sig['queue_depth']})")
            why_down = "idle"
        if self._breach((model, "replicas", "up"), up) \
                and self._cooled(model, "replicas"):
            self._act(model, "replicas", "up",
                      lambda: self.serving.resize_model_replicas(
                          model, cur + 1), why_up)
        elif self._breach((model, "replicas", "down"), down) \
                and self._cooled(model, "replicas"):
            self._act(model, "replicas", "down",
                      lambda: self.serving.resize_model_replicas(
                          model, cur - 1), why_down)

    def _scale_deadline(self, sig: Dict[str, Any]) -> None:
        pol = self.policy
        batcher = getattr(self.serving, "_batcher", None)
        if batcher is None:
            return
        cur_ms = batcher.max_latency * 1e3
        over_slo = any(m["slo_ms"] > 0 and m["p99_ms"] > m["slo_ms"]
                       for m in sig["models"].values())
        up = (sig["queue_depth"] >= pol.queue_high and not over_slo
              and cur_ms < pol.max_batch_delay_ms)
        down = over_slo and cur_ms > pol.min_batch_delay_ms
        if self._breach((ALL_MODELS, "batch_deadline", "up"), up) \
                and self._cooled(ALL_MODELS, "batch_deadline"):
            ms = min(pol.max_batch_delay_ms, cur_ms * 2)
            self._act(ALL_MODELS, "batch_deadline", "up",
                      lambda: self.serving.set_batch_deadline_ms(ms),
                      f"queue deep ({sig['queue_depth']}), SLOs met — "
                      "batch harder")
        elif self._breach((ALL_MODELS, "batch_deadline", "down"), down) \
                and self._cooled(ALL_MODELS, "batch_deadline"):
            ms = max(pol.min_batch_delay_ms, cur_ms / 2)
            self._act(ALL_MODELS, "batch_deadline", "down",
                      lambda: self.serving.set_batch_deadline_ms(ms),
                      "over SLO — flush sooner")

    def stats(self) -> Dict[str, Any]:
        return {"actions": len(self.actions),
                "last": self.actions[-1] if self.actions else None}

    # -- audited-action export (the loadgen convergence assertions) --------

    def export_actions(self) -> List[Dict[str, Any]]:
        """Deep-copied audit list, safe to hold across further ticks."""
        return [dict(a) for a in list(self.actions)]

    def audit(self, flap_window_s: Optional[float] = None) -> Dict[str, Any]:
        """Convergence audit over the applied-action ledger — see
        :func:`audit_actions`.  The flap window defaults to twice the
        policy cooldown: a reversal inside it means the dampers lost."""
        return audit_actions(self.export_actions(),
                             cooldown_s=self.policy.cooldown_s,
                             now=self._clock(),
                             flap_window_s=flap_window_s)


def audit_actions(actions: List[Dict[str, Any]], cooldown_s: float,
                  now: Optional[float] = None,
                  flap_window_s: Optional[float] = None) -> Dict[str, Any]:
    """Hysteresis audit over an action ledger (pure — tests feed
    fabricated ledgers).

    A **flap** is a direction reversal on the same (model, resource)
    within ``flap_window_s`` (default ``2 * cooldown_s``) of the
    previous action: up→down→up churn the hysteresis + cooldown
    dampers exist to prevent.  ``quiet_s`` is the time since the last
    action (None with no ``now``); the soak's convergence assertion is
    ``flaps == 0`` plus a long-enough quiet tail.
    """
    window = float(flap_window_s if flap_window_s is not None
                   else 2.0 * cooldown_s)
    flaps: List[Dict[str, Any]] = []
    last_by_key: Dict[tuple, Dict[str, Any]] = {}
    by_label: Dict[str, int] = {}
    for a in actions:
        key = (a["model"], a["resource"])
        label = f"{a['model']}/{a['resource']}/{a['direction']}"
        by_label[label] = by_label.get(label, 0) + 1
        prev = last_by_key.get(key)
        if prev is not None and prev["direction"] != a["direction"] \
                and a["t"] - prev["t"] < window:
            flaps.append({"model": a["model"], "resource": a["resource"],
                          "from": prev["direction"], "to": a["direction"],
                          "gap_s": a["t"] - prev["t"]})
        last_by_key[key] = a
    last_t = actions[-1]["t"] if actions else None
    return {
        "total": len(actions),
        "by_label": by_label,
        "flap_window_s": window,
        "flaps": len(flaps),
        "flap_events": flaps,
        "last_t": last_t,
        "quiet_s": (None if now is None or last_t is None
                    else max(0.0, now - last_t)),
    }
