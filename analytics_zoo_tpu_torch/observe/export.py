"""Exporters for the observability layer.

Three formats, one registry:

- ``to_prometheus`` — the Prometheus text exposition format (counters
  and gauges verbatim; histograms as summaries with ``quantile``
  labels plus ``_sum``/``_count``).  ``parse_prometheus`` is the exact
  inverse used by the round-trip tests.
- ``JsonlEventLog`` — an append-only structured event log (one JSON
  object per line: spans as they complete, metric dumps, flight
  records, free-form markers).  Attach to a ``Tracer`` to stream spans.
- ``publish_to_summary`` — bridges gauges / counters / histogram
  percentiles into the no-TF TensorBoard writer (``core/summary.py``)
  so training dashboards see the same series that serving ``health()``
  exposes.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Optional, Tuple

from analytics_zoo_tpu_torch.observe.metrics import (METRICS,
                                                     MetricsRegistry,
                                                     render_series)
from analytics_zoo_tpu_torch.observe.trace import Tracer

__all__ = ["to_prometheus", "parse_prometheus", "JsonlEventLog",
           "publish_to_summary"]


def _esc(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    f = float(value)
    if f != f:
        return "NaN"
    return repr(f) if f != int(f) else str(int(f))


def _render(name: str, labels, extra: Tuple[Tuple[str, str], ...] = ()
            ) -> str:
    pairs = tuple(labels) + tuple(extra)
    if not pairs:
        return name
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in pairs)
    return f"{name}{{{inner}}}"


def to_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Dump the registry in Prometheus text format (version 0.0.4)."""
    reg = registry if registry is not None else METRICS
    lines = []
    for name, kind, help_, series in reg.collect():
        if help_:
            lines.append(f"# HELP {name} {_esc(help_)}")
        ptype = "summary" if kind == "histogram" else kind
        lines.append(f"# TYPE {name} {ptype}")
        for labels, value in series:
            if kind == "histogram":
                for q, key in (("0.5", "p50"), ("0.99", "p99")):
                    if value[key] is not None:
                        lines.append(
                            f"{_render(name, labels, (('quantile', q),))}"
                            f" {_fmt(value[key])}")
                lines.append(
                    f"{_render(name + '_sum', labels)} "
                    f"{_fmt(value['sum'])}")
                lines.append(
                    f"{_render(name + '_count', labels)} "
                    f"{_fmt(value['count'])}")
            else:
                lines.append(f"{_render(name, labels)} {_fmt(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


_LINE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unesc(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Inverse of ``to_prometheus``: returns ``{"series": {rendered ->
    float}, "types": {name -> type}}``.  Raises ``ValueError`` on any
    line that is neither a comment nor a well-formed sample."""
    series: Dict[str, float] = {}
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable prometheus line: {raw!r}")
        labels = tuple(sorted(
            (k, _unesc(v))
            for k, v in _LABEL_RE.findall(m.group("labels") or "")))
        series[render_series(m.group("name"), labels)] = \
            float(m.group("value"))
    return {"series": series, "types": types}


class JsonlEventLog:
    """Append-only JSONL event stream; one object per line, each with
    ``ts`` and ``kind``.  Thread-safe; a write failure disables the log
    rather than poisoning the emitting pipeline."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, kind: str, **payload: Any) -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(payload)
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except (OSError, ValueError):
                self._close_locked()

    def span_sink(self, span_dict: Dict[str, Any]) -> None:
        """``tracer.add_sink(log.span_sink)`` streams completed spans."""
        self.emit("span", span=span_dict)

    def metrics_dump(self, registry: Optional[MetricsRegistry] = None,
                     delta: Optional[Dict[str, Any]] = None) -> None:
        reg = registry if registry is not None else METRICS
        self.emit("metrics", dump=delta if delta is not None
                  else reg.delta(None))

    def attach(self, tracer: Tracer) -> None:
        tracer.add_sink(self.span_sink)

    def detach(self, tracer: Tracer) -> None:
        tracer.remove_sink(self.span_sink)

    def _close_locked(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._close_locked()


def publish_to_summary(writer, step: int,
                       registry: Optional[MetricsRegistry] = None,
                       prefix: str = "") -> int:
    """Write the registry into a ``core.summary.SummaryWriter``.

    Gauges and counters land under their rendered series name;
    histograms land as ``<series>/p50`` and ``<series>/p99``.  Returns
    the number of scalars written.  ``prefix`` filters by metric name
    (e.g. ``"train_"``).
    """
    reg = registry if registry is not None else METRICS
    wrote = 0
    for name, kind, _help, series in reg.collect():
        if prefix and not name.startswith(prefix):
            continue
        for labels, value in series:
            tag = _render(name, labels)
            if kind == "histogram":
                for key in ("p50", "p99"):
                    if value[key] is not None:
                        writer.add_scalar(f"{tag}/{key}", value[key],
                                          step)
                        wrote += 1
            else:
                writer.add_scalar(tag, float(value), step)
                wrote += 1
    return wrote
