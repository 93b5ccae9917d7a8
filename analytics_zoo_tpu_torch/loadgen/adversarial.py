"""Adversarial legs: clients that misbehave on purpose.

Production traffic is not all well-formed and prompt.  Three legs
(docs/LOADGEN.md "Adversarial legs") pin that the serving pipeline
degrades *typed*, never silent, and that one bad client cannot starve
its neighbours:

- :class:`SlowClient` — sends a burst, then sits on the answers for
  ``hold_s`` before collecting.  On the shm backend the un-collected
  results pin result slots (the lease protocol); the assertion is that
  a concurrent well-behaved client keeps its own latency while the
  slow one holds.
- :func:`malformed_flood` — pushes raw records straight onto the queue
  *bypassing* ``InputQueue``'s client-side validation (no tensor
  fields, unknown model, garbage TTL).  Every one must come back as a
  typed ``malformed``/``decode_error`` payload.
- :func:`expired_ttl_flood` — enqueues with a TTL that expires before
  any plausible service: the poller sheds them as typed ``expired``
  (or ``overloaded`` via the time-to-answer estimate) without paying
  decode or device time for them.
- :func:`host_kill` — SIGKILLs one *serving process* of a pod at a
  scheduled offset into the storm (a real OS kill, not an injected
  exception).  The survivors must quarantine the whole mesh replica
  within the barrier timeout and every accepted request must still
  terminate as a result or a typed error — the chaos leg behind the
  ``kill`` pod rows in docs/LOADGEN.md.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["SlowClient", "malformed_flood", "expired_ttl_flood",
           "host_kill"]


class SlowClient:
    """Send ``n`` requests, hold the results unclaimed for ``hold_s``,
    then collect.  Returns per-uri terminal values from :meth:`collect`
    so tests can assert the slow traffic itself still terminates."""

    def __init__(self, input_queue, output_queue, model: str,
                 shape=(4,), n: int = 8, hold_s: float = 1.0,
                 uri_prefix: str = "slow", seed: int = 0):
        self.inp = input_queue
        self.outp = output_queue
        self.model = model
        self.shape = tuple(shape)
        self.n = int(n)
        self.hold_s = float(hold_s)
        self.uri_prefix = uri_prefix
        self._rng = np.random.Generator(np.random.PCG64(int(seed)))
        self.uris: List[str] = []

    def send(self) -> List[str]:
        for i in range(self.n):
            uri = f"{self.uri_prefix}-{i:04d}"
            x = self._rng.uniform(0, 1, self.shape).astype(np.float32)
            self.inp.enqueue(uri=uri, model=self.model, x=x)
            self.uris.append(uri)
        return list(self.uris)

    def collect(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Sleep out the hold, then claim every held answer."""
        time.sleep(self.hold_s)
        out: Dict[str, Any] = {}
        for uri in self.uris:
            out[uri] = self.outp.query(uri, timeout=timeout_s)
        return out


def malformed_flood(queue, n: int = 16,
                    uri_prefix: str = "mal") -> List[str]:
    """Push ``n`` invalid records DIRECTLY onto the queue backend —
    past ``InputQueue.enqueue``'s client-side rejection — cycling the
    malformations a hostile or buggy producer would emit.  Returns the
    rids to assert typed answers against."""
    rids: List[str] = []
    for i in range(n):
        uri = f"{uri_prefix}-{i:04d}-{uuid.uuid4().hex[:6]}"
        kind = i % 3
        rec: Dict[str, Any] = {"uri": uri, "ts": time.time(),
                               "fmt": "tensor"}
        if kind == 0:
            pass                             # no tensor fields at all
        elif kind == 1:
            rec["model"] = "no_such_model"   # unroutable
            rec["x"] = np.zeros((2,), np.float32)
        else:
            rec["x"] = {"b64": "!!not-base64!!", "dtype": "float32",
                        "shape": [2]}        # rotten payload
        rids.append(queue.push(rec))
    return rids


def expired_ttl_flood(input_queue, model: Optional[str] = None,
                      n: int = 16, shape=(4,), ttl_ms: float = 0.01,
                      uri_prefix: str = "ttl", seed: int = 0) -> List[str]:
    """Enqueue ``n`` well-formed records whose TTL is already hopeless
    (default 0.01ms): the worker must shed each with a typed
    ``expired``/``overloaded`` error before decode, never serve a
    stale answer."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    uris: List[str] = []
    for i in range(n):
        uri = f"{uri_prefix}-{i:04d}"
        x = rng.uniform(0, 1, tuple(shape)).astype(np.float32)
        input_queue.enqueue(uri=uri, model=model, ttl_ms=float(ttl_ms),
                            x=x)
        uris.append(uri)
    return uris


def host_kill(proc, at_s: float = 0.0) -> threading.Thread:
    """SIGKILL a serving process ``at_s`` seconds from now.

    ``proc`` is a ``subprocess.Popen`` / ``multiprocessing.Process``
    (anything with a ``pid``) or a raw pid.  The kill is delivered on a
    daemon timer thread so the caller can start the storm first and let
    the host die mid-flight; join the returned thread to sequence
    assertions after the kill.  SIGKILL is deliberate — no atexit, no
    finally blocks, no graceful drain — because the recovery contract
    being tested is the *survivors'* barrier timeout, not the victim's
    shutdown path.  Already-dead victims are ignored (idempotent under
    races with natural exit).
    """
    pid = int(getattr(proc, "pid", proc))

    def _kill() -> None:
        if at_s > 0:
            time.sleep(at_s)
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    t = threading.Thread(target=_kill, name=f"host_kill_{pid}",
                         daemon=True)
    t.start()
    return t
