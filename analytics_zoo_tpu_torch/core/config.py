"""Unified typed configuration.

A single dataclass is the source of truth; env vars with the ``ZOO_``
prefix override fields.  This is the JAX package's ``ZooConfig`` cut to
the knobs the ported modules read.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

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
    # Sequence shards for the attention layers (nn/layers/attention.py):
    # > 1 routes self-attention through ring attention over that many
    # devices, which needs the multi-GPU slice and raises until then;
    # 0 = off.
    seq_shards: int = 0
    # Seed of the default parameter-initialisation generator, of the
    # Estimator's shuffles and of its dropout generator.
    seed: int = 42

    # -- training (train/estimator.py), the JAX package's defaults -------
    # K > 1 moves K batches to the device in one copy per array and runs
    # them as K steps (the same step sequence as K = 1).
    steps_per_execution: int = 1
    # What a non-finite training loss does.  Every such step is discarded
    # on the device (params and optimizer state keep their values) and
    # counted; the policy is applied once per epoch:
    #   "skip"     — go on; raise once >= max_bad_steps are consecutive.
    #   "raise"    — raise FloatingPointError at the epoch boundary.
    #   "rollback" — like skip, plus: >= max_bad_steps consecutive bad
    #                steps roll back to the last checkpoint and scale the
    #                learning rate by nan_backoff_factor; without a
    #                checkpoint it raises, as the JAX package does.
    nan_policy: str = "skip"
    max_bad_steps: int = 5
    nan_backoff_factor: float = 0.5
    # Default cache level of a FeatureSet without one: "HOST" batches on
    # the host and copies each to the device; "DEVICE" holds the whole set
    # on the device when it fits data_device_budget_bytes (else HOST).
    data_cache_level: str = "HOST"
    data_device_budget_bytes: int = 4 << 30
    # Batches the host path prepares ahead of the step on a producer
    # thread (train/prefetch.py); 0 prepares them in line.
    data_prefetch: int = 2
    # Compute dtype of the training forward and backward: "bfloat16"
    # casts parameters and float inputs for them while the f32 masters
    # and optimizer state stay f32 (train/estimator.py).
    compute_dtype: str = "float32"

    # -- checkpoints and failure retry (train/checkpoint.py, the JAX
    # package's defaults) ------------------------------------------------
    # A directory fit(resume=True) resumes from when set_checkpoint was
    # not called.
    checkpoint_dir: Optional[str] = None
    # Snapshots copied off the live tensors, then written on a thread.
    async_checkpoint: bool = True
    # Verify per-leaf CRC32 manifests on restore; torn or corrupt
    # snapshots are quarantined and restore falls back to the newest
    # intact one.
    ckpt_verify: bool = True
    # Failure retry of fit from the last checkpoint: at most this many
    # failures within a sliding window of this many seconds.
    failure_retry_times: int = 5
    failure_retry_interval_s: float = 120.0
    # RetryPolicy defaults (robust/retry.py): exponential backoff with
    # jitter, bounded by attempts and an optional deadline.
    retry_max_attempts: int = 5
    retry_base_delay_s: float = 0.1
    retry_max_delay_s: float = 30.0
    retry_multiplier: float = 2.0
    retry_jitter: float = 0.1
    retry_deadline_s: Optional[float] = None

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
    if "float" in t:
        return float(raw)
    if "bool" in t:
        return raw.lower() in ("1", "true", "yes", "on")
    return raw
