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
The JAX package's TPU minimum-work gates (a 4096-row table, a 256x256
weight, the flash kernel's D % 128 and L >= 2048) are not carried over:
they come back once measured on the card.  The 4096-row gate was
(``bag_shapes.py``): the bag kernel leads ``F.embedding_bag`` at every
table size from 1024 rows up, so it stays out.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

PATH_CUDA = "cuda"
PATH_REFERENCE = "reference"
_PATHS = (PATH_CUDA, PATH_REFERENCE)

# the path ``forced`` pins for the duration of its block; None otherwise
_FORCED: Optional[str] = None


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


def record_selection(kernel: str, path: str) -> None:
    """Count one routing decision."""
    from analytics_zoo_tpu_torch.observe import metrics as _metrics

    _metrics.count("ops_kernel_selected_total", 1,
                   flat=f"{kernel}/{path}", kernel=kernel, path=path)


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


class LaunchCount:
    """A kernel wrapper's launch count: one per launch, thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
