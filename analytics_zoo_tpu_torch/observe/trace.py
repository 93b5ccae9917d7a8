"""Structured tracing: trace/span ids that ride along with work as it
hops threads, plus a bounded ring of completed spans so any request's
timeline is reconstructable after the fact.

The model is deliberately small:

- a **trace** is a string id grouping the spans of one logical unit of
  work (one serving record, one ``Estimator.fit`` run, one standalone
  checkpoint op);
- a **span** is a named interval inside a trace with a parent pointer
  (``parent`` is the parent span's ``sid``, ``None`` for the root), a
  terminal ``status`` (``"ok"`` or a typed error/shed code such as
  ``"expired"``), and free-form ``attrs``;
- completed spans land in a bounded deque (the *span ring*); live spans
  sit in a side table until ended.  Nothing is sampled away below the
  ring bound — eviction is strictly oldest-first.

Spans are cheap (a dict append under a lock) and are safe to create on
any thread: the serving pipeline starts a root span at queue-claim time
and threads the ``(trace, sid)`` pair through the decode pool, the
DynamicBatcher and the DeviceExecutor to the respond pool.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "TRACER", "span", "find_orphans"]

_DEFAULT_RING = int(os.environ.get("ZOO_OBSERVE_SPAN_RING", "4096"))


class Span:
    """One timed interval.  Created via ``Tracer.start``; call
    ``end(status, **attrs)`` exactly once (double-end is a no-op)."""

    __slots__ = ("trace", "sid", "parent", "name", "t0", "t1", "status",
                 "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", trace: str, sid: int,
                 parent: Optional[int], name: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.trace = trace
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0 = time.time()
        self.t1: Optional[float] = None
        self.status = "open"
        self.attrs = attrs

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def end(self, status: str = "ok", **attrs: Any) -> None:
        self._tracer._finish(self, status, attrs)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace": self.trace, "sid": self.sid, "parent": self.parent,
            "name": self.name, "t0": self.t0, "t1": self.t1,
            "duration_s": self.duration_s, "status": self.status,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name} trace={self.trace} sid={self.sid} "
                f"parent={self.parent} status={self.status})")

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.end(status="error", error=repr(exc))
        else:
            self.end()


class Tracer:
    """Issues spans and keeps the bounded ring of completed ones."""

    def __init__(self, ring: int = _DEFAULT_RING):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._done: deque = deque(maxlen=max(16, int(ring)))
        self._active: Dict[int, Span] = {}
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []

    # -- span lifecycle ----------------------------------------------------

    def start(self, name: str, trace: Optional[str] = None,
              parent: Optional[int] = None, **attrs: Any) -> Span:
        sid = next(self._ids)
        sp = Span(self, trace or f"t{sid}", sid, parent, name, attrs)
        with self._lock:
            self._active[sid] = sp
        return sp

    def _finish(self, sp: Span, status: str,
                attrs: Dict[str, Any]) -> None:
        sinks: List[Callable[[Dict[str, Any]], None]] = []
        with self._lock:
            if sp.sid not in self._active:
                return  # already ended; keep the first terminal status
            del self._active[sp.sid]
            sp.t1 = time.time()
            sp.status = status
            if attrs:
                sp.attrs.update(attrs)
            self._done.append(sp)
            sinks = list(self._sinks)
        if sinks:
            d = sp.to_dict()
            for fn in sinks:
                try:
                    fn(d)
                except Exception:
                    pass  # a broken sink must never break the pipeline

    # -- sinks -------------------------------------------------------------

    def add_sink(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    # -- introspection -----------------------------------------------------

    def resize(self, ring: int) -> None:
        with self._lock:
            if self._done.maxlen != max(16, int(ring)):
                self._done = deque(self._done, maxlen=max(16, int(ring)))

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def completed_count(self) -> int:
        return len(self._done)

    def ring_size(self) -> int:
        return self._done.maxlen or 0

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Completed spans, oldest first, as plain dicts."""
        with self._lock:
            spans = list(self._done)
        if limit is not None:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def spans(self, trace: str) -> List[Dict[str, Any]]:
        """All completed spans of one trace, ordered by (t0, sid)."""
        with self._lock:
            hits = [s for s in self._done if s.trace == trace]
        hits.sort(key=lambda s: (s.t0, s.sid))
        return [s.to_dict() for s in hits]

    def verify_chain(self, trace: str) -> Dict[str, Any]:
        """Reconstruct one trace and check its structural integrity.

        ``complete`` means: a root span exists (parent None), every
        non-root span's parent sid is present in the trace, and the
        root carries a terminal status (anything but ``"open"``).
        """
        spans = self.spans(trace)
        roots = [s for s in spans if s["parent"] is None]
        orphans = find_orphans(spans)
        root = roots[0] if roots else None
        return {
            "trace": trace,
            "spans": spans,
            "root": root,
            "orphans": orphans,
            "terminal": root["status"] if root else None,
            "complete": bool(root) and not orphans and
            bool(root) and root["status"] != "open",
        }

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self._active.clear()


def find_orphans(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Spans whose parent sid is missing from the same span list."""
    sids = {s["sid"] for s in spans}
    return [s for s in spans
            if s["parent"] is not None and s["parent"] not in sids]


TRACER = Tracer()


@contextmanager
def span(name: str, trace: Optional[str] = None,
         parent: Optional[int] = None, tracer: Optional[Tracer] = None,
         **attrs: Any):
    """``with span("train/epoch", trace=t, epoch=3) as sp: ...`` — ends
    with status ``"ok"``, or ``"error"`` if the body raises."""
    sp = (tracer or TRACER).start(name, trace=trace, parent=parent,
                                  **attrs)
    try:
        yield sp
    except BaseException as e:
        sp.end(status="error", error=repr(e))
        raise
    else:
        sp.end()
