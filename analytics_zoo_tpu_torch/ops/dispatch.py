"""Shared routing for the CUDA kernels in ``ops/``.

Every hand-written kernel here (embedding_bag and its backward,
dequant_matmul, flash_attention and its backward) faces the same
choice:

- ``"cuda"``       — the kernel compiled from ``csrc/`` for ``sm_90a``;
  taken for every CUDA tensor unless the bag's knob ``fused_embedding``
  says ``off`` (the dequantize-matmul and flash attention have no knob;
  a masked or dropout attention, or one whose dtype or head width the
  kernel cannot take, takes the JAX package's other route in
  ``ops.attention.dot_product_attention``, counted as ``reference``).
- ``"reference"``  — the plain PyTorch version: the oracle the tests and
  ``chip_smoke.py`` compare against, and the path for CPU tensors.

A CUDA tensor reaches the plain version only through the knob ``off`` or
an explicit ``force`` (``forced`` below); shapes the kernel cannot take
raise rather than quietly run the plain version on the card.

``select_path`` is the one predicate behind both kernels and records every
decision in ``ops_kernel_selected_total{kernel,path}``, so a serving run
can show from metrics alone that its hot loop went through the kernels.

Under a CUDA graph (``core/graphs.py``) the Python of a wrapper runs once,
at the capture, and the kernel once per replay.  So a launch or a routing
decision made while the current stream is capturing is recorded in the
capture's ``LaunchRecord`` instead of counted, and every replay of the
graph adds the record: the counts stay launches, not Python calls.
The JAX package's TPU minimum-work gates (a 4096-row table, a 256x256
weight, the flash kernel's D % 128 and L >= 2048) are not carried over:
they come back once measured on the card.  The 4096-row gate was
(``bag_shapes.py``): the bag kernel leads ``F.embedding_bag`` at every
table size from 1024 rows up, so it stays out.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading
import types
from typing import Iterator, Optional

import torch

PATH_CUDA = "cuda"
PATH_REFERENCE = "reference"
_PATHS = (PATH_CUDA, PATH_REFERENCE)

# the path ``forced`` pins for the duration of its block; None otherwise
_FORCED: Optional[str] = None
# the record of the capture in progress (one at a time in a process)
_RECORD: Optional["LaunchRecord"] = None


def _check_path(path: str) -> str:
    if path not in _PATHS:
        raise ValueError(f"unknown kernel path {path!r}; "
                         f"expected one of {_PATHS}")
    return path


@contextlib.contextmanager
def forced(path: str) -> Iterator[None]:
    """Route every kernel call made inside the block to ``path``.

    This is how a check runs the plain versions on the card beside the
    kernels (``chip_smoke.py``); it is not configuration and lasts for
    the block only.  Calls from any thread see it.
    """
    global _FORCED
    before, _FORCED = _FORCED, _check_path(path)
    try:
        yield
    finally:
        _FORCED = before


def config_knob(name: str, default=None):
    """Read one knob off the global ZooConfig without *creating* a
    context: an uninitialised context just yields ``default``."""
    from analytics_zoo_tpu_torch.core import context as _context

    ctx = _context._GLOBAL_CONTEXT
    if ctx is None:
        return default
    return getattr(ctx.config, name, default)


def forced_path() -> Optional[str]:
    """The path ``forced`` pins now, or None."""
    return _FORCED


def _count_selection(kernel: str, path: str, n: int) -> None:
    from analytics_zoo_tpu_torch.observe import metrics as _metrics

    _metrics.count("ops_kernel_selected_total", n,
                   flat=f"{kernel}/{path}", kernel=kernel, path=path)


def record_selection(kernel: str, path: str) -> None:
    """Count one routing decision (record it, under a capture)."""
    rec = _capturing()
    if rec is not None:
        rec.selections[(kernel, path)] += 1
    else:
        _count_selection(kernel, path, 1)


def select_path(kernel: str, *, device: torch.device,
                shapes_ok: bool = True,
                shape: str = "",
                knob: Optional[str] = None,
                force: Optional[str] = None) -> str:
    """The one routing predicate shared by the ops/ kernels.

    ``device``     where the call's tensors live: CUDA tensors take the
                   kernel, CPU tensors the plain version.
    ``shapes_ok``  kernel-specific hard limits.  When False a CPU tensor
                   takes the plain version and a CUDA tensor raises
                   ``ValueError`` naming the kernel and ``shape``.
    ``knob``       the governing config knob: "off" pins the reference
                   path; "auto"/"on"/None defer to the device.
    ``force``      explicit caller override, one of the path names;
                   defaults to the path ``forced`` pins, if any.

    Returns the chosen path name and records it in
    ``ops_kernel_selected_total``.
    """
    if force is None:
        force = _FORCED
    on_cuda = torch.device(device).type == "cuda"
    if force is not None:
        path = _check_path(force)
    elif knob == "off":
        path = PATH_REFERENCE
    elif not shapes_ok:
        if on_cuda:
            raise ValueError(f"the {kernel} CUDA kernel cannot take {shape}")
        path = PATH_REFERENCE
    elif on_cuda:
        path = PATH_CUDA
    else:
        path = PATH_REFERENCE
    record_selection(kernel, path)
    return path


class LaunchRecord:
    """What one CUDA graph launches per replay: launches by counter and
    routing decisions by (kernel, path)."""

    def __init__(self) -> None:
        self.launches: collections.Counter = collections.Counter()
        self.selections: collections.Counter = collections.Counter()

    def replay(self) -> None:
        """Count one replay of the graph."""
        for counter, n in self.launches.items():
            counter._bump(n)
        for (kernel, path), n in self.selections.items():
            _count_selection(kernel, path, n)

    def per_replay(self) -> dict:
        """{kernel counter name: launches per replay}."""
        return {c.name: n for c, n in self.launches.items()}


def _capturing() -> Optional[LaunchRecord]:
    """The capture's record when the calling thread's current stream is
    the capturing one (the autograd engine's device thread runs a
    captured backward on it too), else None."""
    rec = _RECORD
    if rec is None or not torch.cuda.is_current_stream_capturing():
        return None
    return rec


@contextlib.contextmanager
def recording() -> Iterator[LaunchRecord]:
    """Record, instead of counting, the launches and routing decisions
    made on a capturing stream inside the block (``core/graphs.py`` wraps
    each capture in it, under its process-wide capture lock)."""
    global _RECORD
    rec = LaunchRecord()
    before, _RECORD = _RECORD, rec
    try:
        yield rec
    finally:
        _RECORD = before


class LaunchCount:
    """A kernel wrapper's launch count: one per launch, thread-safe; a
    launch inside a graph capture counts at each replay instead."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        rec = _capturing()
        if rec is not None:
            rec.launches[self] += 1
        else:
            self._bump(1)

    def _bump(self, n: int) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


class _CallableModule(types.ModuleType):
    """A kernel's module that is also its function.  The JAX package's
    ``ops`` exports the functions ``embedding_bag``, ``dequant_matmul``
    and ``flash_attention`` under the names of their modules; here the
    module keeps its name and attributes (``ops.embedding_bag.bag_layout``,
    ``import analytics_zoo_tpu_torch.ops.embedding_bag``) and a call runs
    its namesake function (``ops.embedding_bag(table, ids)``)."""

    def __call__(self, *args, **kw):
        return getattr(self, self.__name__.rsplit(".", 1)[1])(*args, **kw)


def callable_module(name: str) -> None:
    """Make module ``name`` callable as its namesake function."""
    sys.modules[name].__class__ = _CallableModule
