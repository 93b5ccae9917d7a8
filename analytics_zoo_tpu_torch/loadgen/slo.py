"""Fold per-request records into the pinned SLO artifact.

The reporter turns a flat list of
:class:`~analytics_zoo_tpu_torch.loadgen.client.RequestRecord` timelines
into the numbers the SLO artifact pins (docs/LOADGEN.md "SLO artifact
schema"):

- **windows** — fixed-width time buckets over the run, each with
  offered/answered counts, per-model p99, and shed/lost tallies.  All
  downstream folds read windows, so a stall shows up as *windows over
  SLO*, not as a diluted whole-run percentile.
- **sustained QPS at SLO** — the highest offered rate averaged over
  ``min_consec`` CONSECUTIVE windows that all meet p99 < deadline.  A
  single lucky window is not "sustained".
- **shed fraction by model** — typed ``overloaded`` answers / offered,
  per model; the selective-shed assertion reads this.
- **recovery time to SLO** — after an event (burst end, process kill),
  seconds until the first of ``min_consec`` consecutive compliant
  windows.  ``None`` = never recovered inside the run.

Artifacts are plain JSON (``write_artifact``), the JAX package's schema.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["percentile", "fold_windows", "sustained_qps_at_slo",
           "shed_fraction_by_model", "recovery_time_to_slo",
           "outcome_counts", "write_artifact"]

_SHED_CODES = ("overloaded", "expired")


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile; None for an empty sample."""
    vs = sorted(float(v) for v in values)
    if not vs:
        return None
    idx = min(len(vs) - 1, max(0, int(math.ceil(q / 100.0 * len(vs))) - 1))
    return vs[idx]


def outcome_counts(records) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in records:
        out[r.outcome] = out.get(r.outcome, 0) + 1
    return out


def fold_windows(records, window_s: float = 1.0,
                 duration_s: Optional[float] = None) -> List[Dict[str, Any]]:
    """Bucket records by schedule time into ``window_s`` windows.

    Latency is schedule-to-answer (``RequestRecord.latency_s``), so a
    request delayed by a stalled server lands its full queueing delay
    in the window it was OFFERED in — the coordinated-omission-honest
    accounting.
    """
    if window_s <= 0:
        raise ValueError(f"window_s must be positive, got {window_s}")
    records = list(records)
    if duration_s is None:
        duration_s = max((r.t_sched for r in records), default=0.0) + 1e-9
    n_win = max(1, int(math.ceil(duration_s / window_s)))
    wins: List[Dict[str, Any]] = [
        {"t_start": i * window_s, "t_end": (i + 1) * window_s,
         "offered": 0, "answered": 0, "shed": 0, "lost": 0,
         "latencies_ms": {}}
        for i in range(n_win)]
    for r in records:
        i = min(n_win - 1, int(r.t_sched / window_s))
        w = wins[i]
        w["offered"] += 1
        if r.outcome == "ok":
            w["answered"] += 1
            lat = r.latency_s
            if lat is not None:
                w["latencies_ms"].setdefault(r.model, []).append(lat * 1e3)
        elif r.outcome in _SHED_CODES:
            w["shed"] += 1
        elif r.outcome in ("lost", "dropped"):
            w["lost"] += 1
        else:
            w["answered"] += 1      # typed error: terminated, not lost
    for w in wins:
        w["offered_qps"] = w["offered"] / window_s
        w["p99_ms"] = {m: percentile(ls, 99)
                       for m, ls in w["latencies_ms"].items()}
        del w["latencies_ms"]
    return wins


def _window_meets(w: Dict[str, Any], slo_ms_by_model: Dict[str, float],
                  require_answers: bool) -> bool:
    if w["lost"]:
        return False
    if require_answers and not w["answered"]:
        return False
    for model, slo in slo_ms_by_model.items():
        if slo <= 0:
            continue
        p99 = w["p99_ms"].get(model)
        if p99 is not None and p99 > slo:
            return False
    return True


def sustained_qps_at_slo(windows: Sequence[Dict[str, Any]],
                         slo_ms_by_model: Dict[str, float],
                         min_consec: int = 3) -> Optional[float]:
    """Best offered QPS averaged over any ``min_consec`` consecutive
    windows that ALL meet every model's p99 SLO (and lost nothing)."""
    best: Optional[float] = None
    run: List[float] = []
    for w in windows:
        if _window_meets(w, slo_ms_by_model, require_answers=True):
            run.append(w["offered_qps"])
            if len(run) >= min_consec:
                qps = sum(run[-min_consec:]) / min_consec
                if best is None or qps > best:
                    best = qps
        else:
            run = []
    return best


def shed_fraction_by_model(records) -> Dict[str, float]:
    """Typed sheds (overloaded/expired) over offered, per model."""
    offered: Dict[str, int] = {}
    shed: Dict[str, int] = {}
    for r in records:
        offered[r.model] = offered.get(r.model, 0) + 1
        if r.outcome in _SHED_CODES:
            shed[r.model] = shed.get(r.model, 0) + 1
    return {m: shed.get(m, 0) / n for m, n in offered.items() if n}


def recovery_time_to_slo(windows: Sequence[Dict[str, Any]],
                         event_t: float,
                         slo_ms_by_model: Dict[str, float],
                         min_consec: int = 2) -> Optional[float]:
    """Seconds from ``event_t`` to the start of the first
    ``min_consec``-window compliant streak at or after it.  0.0 means
    the event never dented the SLO; None means no recovery in-run."""
    idxs = [i for i, w in enumerate(windows) if w["t_end"] > event_t]
    streak = 0
    for i in idxs:
        if _window_meets(windows[i], slo_ms_by_model,
                         require_answers=False):
            streak += 1
            if streak >= min_consec:
                start = windows[i - min_consec + 1]["t_start"]
                return max(0.0, start - event_t)
        else:
            streak = 0
    return None


def write_artifact(path: str, report: Dict[str, Any]) -> str:
    """Atomic JSON write (tmp + replace) — a reader never sees a torn
    artifact, and strict JSON (no NaN/Infinity) is enforced."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True,
                      allow_nan=False)
            f.write("\n")
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
