"""Unified typed configuration.

A single dataclass is the source of truth; env vars with the ``ZOO_``
prefix override fields.  This is the JAX package's ``ZooConfig`` cut to
the knobs the ported modules read.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict

_ENV_PREFIX = "ZOO_"


@dataclass
class ZooConfig:
    """Global framework configuration."""

    # Fused embedding-bag kernel routing (ops/embedding_bag.py): "auto"
    # and "on" launch the CUDA kernel for every CUDA tensor, "off" pins
    # the plain PyTorch version.
    fused_embedding: str = "auto"
    # Serving weight storage (deploy/inference.py): "float32" keeps full
    # precision; "int8" / "int4" store weights quantized per output
    # channel and dequantize inside the serving forward — Dense kernels
    # through the fused dequantize-matmul kernel.
    serving_weight_dtype: str = "float32"
    # Seed of the default parameter-initialisation generator.
    seed: int = 42

    @classmethod
    def from_env(cls, **overrides: Any) -> "ZooConfig":
        """Build a config from defaults <- ZOO_* env vars <- overrides."""
        kwargs: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                kwargs[f.name] = _coerce(os.environ[env_key], f.type)
        kwargs.update(overrides)
        return cls(**kwargs)

    def replace(self, **kw: Any) -> "ZooConfig":
        return dataclasses.replace(self, **kw)


def _coerce(raw: str, typ: Any) -> Any:
    t = str(typ)
    if "int" in t:
        return int(raw)
    return raw
