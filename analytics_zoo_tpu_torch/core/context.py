"""Framework context: the global config and the device the port runs on.

The JAX package's context builds a device mesh; this one holds a single
device.  Multi-GPU (process groups over NCCL) is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from analytics_zoo_tpu_torch.core.config import ZooConfig

_GLOBAL_CONTEXT: Optional["ZooContext"] = None


@dataclass
class ZooContext:
    """Global config plus the default device (``None`` = ``cuda``)."""

    config: ZooConfig
    device: Optional[str] = None


def init_zoo_context(config: Optional[ZooConfig] = None, *,
                     device: Optional[str] = None,
                     **config_overrides) -> ZooContext:
    """Initialise (or re-initialise) the global framework context."""
    global _GLOBAL_CONTEXT
    if config is None:
        config = ZooConfig.from_env(**config_overrides)
    elif config_overrides:
        config = config.replace(**config_overrides)
    _GLOBAL_CONTEXT = ZooContext(config=config, device=device)
    return _GLOBAL_CONTEXT


def get_zoo_context() -> ZooContext:
    """Current global context, creating a default one on first use."""
    global _GLOBAL_CONTEXT
    if _GLOBAL_CONTEXT is None:
        _GLOBAL_CONTEXT = init_zoo_context()
    return _GLOBAL_CONTEXT


def set_zoo_context(ctx: Optional[ZooContext]) -> None:
    global _GLOBAL_CONTEXT
    _GLOBAL_CONTEXT = ctx


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the
    context's, else ``cuda``.  A CUDA device without a card raises — the
    port never drops to the CPU unless the caller asks for it."""
    if device is None and _GLOBAL_CONTEXT is not None:
        device = _GLOBAL_CONTEXT.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "analytics_zoo_tpu_torch runs on a CUDA device by default and "
            "this process sees none; pass device='cpu' to run on the CPU")
    return dev
