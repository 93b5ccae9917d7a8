"""CUDA graphs: the port's unit of dispatch, its counterpart of ``jax.jit``.

The JAX package dispatches compiled programs, not kernels: a training
step, ``K`` steps under ``steps_per_execution`` (a ``lax.scan``), a
device-resident epoch, or one serving bucket signature is one XLA
executable launched by one call.  Eager PyTorch launches every kernel of
such a program from Python, one by one; on the card that host work, not
the kernels, bounds a small model's step.  A ``StepGraph`` captures the
function once into a CUDA graph and launches it as one replay.

- **Static buffers.**  A graph replays the device addresses it captured,
  so the function reads its inputs from buffers the caller fills in place
  before each replay, and leaves its results in place: in state tensors
  it updates (training) or in the outputs the capture returned (serving).
  The same function runs eagerly on the CPU, where nothing is captured.
- **Warm-up.**  The first call runs the function eagerly on a side
  stream (lazy initialisation, kernel builds and library loads happen
  outside any capture): a training step's warm-up is a real step, a
  serving bucket's its first request.  The next call captures and
  replays.  ``capture()`` captures at once, running the warm-up first if
  it has not run (for a function without side effects).
- **Memory.**  A graph keeps the memory of its captured temporaries for
  as long as it lives, in a private pool, or in ``pool`` (a
  ``torch.cuda.graph_pool_handle()``) shared with graphs that never
  replay at the same time as it, such as one estimator's step programs.
- **Random numbers.**  Every explicit ``torch.Generator`` the function
  draws from is registered with the graph, so each replay draws new bits
  and advances the generator's state as the eager calls would: a replay
  from a state gives the bits an eager call from that state gives.
- **Counts.**  Kernel launch counters and routing decisions made during
  the capture are recorded (``ops.dispatch.recording``) and added at
  every replay, so ``LAUNCHES`` and ``ops_kernel_selected_total`` count
  launches per replay times replays.
- **Failure raises.**  A capture or replay that fails raises
  ``GraphCaptureError`` naming the graph and the port's innermost frame
  at fault (the op); there is no eager fallback on the card.
- **Checks.**  ``disabled()`` runs every graph eagerly for the length of
  a block, from any thread, so a check can hold graphed against eager on
  the card; it is not configuration.  Inside ``dispatch.forced`` the
  graphs run eagerly too, so a graph captured on one kernel path is never
  replayed under another.

Only one capture may be underway in a process (PyTorch's rule), so
captures take a process-wide lock.  They use ``capture_error_mode=
"thread_local"``: the prefetch thread's pinned copies and event waits,
and other models' threads, go on during a capture; the capturing thread
itself may make no call that synchronises.  The libraries keep a handle
per thread (cuBLAS, cuBLASLt, cuDNN), and making one inside a capture
invalidates it, so a thread makes its handles before its first capture
(``_thread_handles``): a serving signature's warm-up may have run in
another thread than the one that captures it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import traceback
from typing import Callable, Iterator, Optional, Sequence

import torch

from analytics_zoo_tpu_torch.ops import dispatch

__all__ = ["StepGraph", "GraphCaptureError", "disabled", "enabled",
           "CAPTURE_ERROR_MODE"]

CAPTURE_ERROR_MODE = "thread_local"

_DISABLED = 0
_DISABLED_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_THREAD = threading.local()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture or replay failed."""


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Run every ``StepGraph`` eagerly inside the block (checks that hold
    graphed against eager on the card; not configuration)."""
    global _DISABLED
    with _DISABLED_LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _DISABLED_LOCK:
            _DISABLED -= 1


def enabled(device) -> bool:
    """Whether a graph on ``device`` is captured and replayed: a CUDA
    device, outside ``disabled()`` and ``dispatch.forced``."""
    return (torch.device(device).type == "cuda" and _DISABLED == 0
            and dispatch.forced_path() is None)


def _culprit(exc: BaseException) -> str:
    """The port's innermost frame in ``exc``'s traceback or the ones it
    chains from (the op a capture refused), as ``file:line: code``."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if f.filename.startswith(_PKG)
                  and not f.filename.endswith(os.path.join("core",
                                                           "graphs.py"))]
        if frames:
            f = frames[-1]
            return (f"{os.path.relpath(f.filename, os.path.dirname(_PKG))}"
                    f":{f.lineno}: {f.line}")
        exc = exc.__cause__ or exc.__context__
    return "no frame of the port"


def _thread_handles(device: torch.device) -> None:
    """Make this thread's cuBLAS, cuBLASLt and cuDNN handles on
    ``device`` (a tiny matmul, a linear with bias and a convolution),
    once per thread and device, outside any capture."""
    done = getattr(_THREAD, "devices", None)
    if done is None:
        done = _THREAD.devices = set()
    if device in done:
        return
    a = torch.ones(8, 8, device=device)
    torch.mm(a, a)
    torch.nn.functional.linear(a, a, a[0])
    if torch.backends.cudnn.is_available():
        torch.nn.functional.conv2d(a.view(1, 1, 8, 8), a[:3, :3].reshape(
            1, 1, 3, 3))
    done.add(device)


class StepGraph:
    """``fn()`` captured once and replayed (see the module docstring).

    ``fn`` takes no arguments: it reads static buffers the caller fills
    and returns its static outputs (or None).  ``generators`` are the
    explicit generators it draws from; ``pool`` is a memory pool handle
    to capture into (None: a private one).  Not thread-safe: a caller
    that shares one across threads holds a lock around the fill, the
    call and the read."""

    def __init__(self, fn: Callable, device, *,
                 generators: Sequence[torch.Generator] = (),
                 pool=None, name: str = "graph"):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.pool = pool
        self.name = name
        self._warmed = False
        self._graph = None
        self._out = None
        self.record: Optional[dispatch.LaunchRecord] = None
        self.capture_s: Optional[float] = None
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self):
        if not enabled(self.device):
            return self.fn()
        if self._graph is None:
            if not self._warmed:
                return self.warm_up()
            self.capture()
        return self.replay()

    def warm_up(self, stream=None):
        """Run ``fn`` once eagerly (never captures): on a side stream, or
        on ``stream`` when one is given, in either case after the work
        the current stream holds."""
        self._warmed = True
        cur = torch.cuda.current_stream(self.device)
        if stream is not None:
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                return self.fn()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        return out

    def capture(self, stream=None) -> None:
        """Capture ``fn`` into a CUDA graph, after the eager warm-up if it
        has not run (run now on a side stream): on ``stream``, or on
        PyTorch's default capture stream.  Graphs captured on one stream
        share its library workspaces, so graphs that may replay at once
        on different streams are captured on different ones."""
        if not enabled(self.device):
            raise GraphCaptureError(f"{self.name}: graphs are off for "
                                    f"{self.device} here")
        with _CAPTURE_LOCK:
            if not self._warmed:
                self.warm_up()
            _thread_handles(self.device)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                for gen in self.generators:
                    graph.register_generator_state(gen)
                with dispatch.recording() as rec:
                    with torch.cuda.graph(
                            graph, pool=self.pool, stream=stream,
                            capture_error_mode=CAPTURE_ERROR_MODE):
                        out = self.fn()
            except Exception as e:
                raise GraphCaptureError(
                    f"CUDA graph capture of {self.name} failed at "
                    f"{_culprit(e)}: {type(e).__name__}: {e}") from e
            self.capture_s = time.perf_counter() - t0
        self._graph, self._out, self.record = graph, out, rec

    def replay(self):
        """Launch the captured graph once; its static outputs."""
        try:
            self._graph.replay()
        except Exception as e:
            raise GraphCaptureError(f"CUDA graph replay of {self.name} "
                                    f"failed: {e}") from e
        self.record.replay()
        self.replays += 1
        return self._out
