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

    # -- serving (deploy/serving.py), the JAX package's defaults ---------
    # The DynamicBatcher dispatches a shape bucket on whichever comes
    # first: batch-full (serving_batch_size rows) or the
    # serving_max_batch_delay_ms deadline.
    serving_batch_size: int = 32
    serving_max_batch_delay_ms: float = 5.0
    # Decode-pool threads: record decode and host preprocess, beside the
    # device's work.
    serving_decode_workers: int = 4
    # Model replicas round-robined by the device executor (each with its
    # own stream and bucket graphs).
    serving_replicas: int = 1
    # Batches in flight per executor (2 = double buffering: batch N+1 is
    # enqueued while N computes; also the backpressure bound).
    serving_max_inflight: int = 2
    # Each replica's circuit breaker quarantines it after this many
    # consecutive dispatch/harvest failures, lets one half-open probe
    # through after the cooldown, and a replica still open past the
    # cooldown is rebuilt by the supervisor.
    serving_breaker_threshold: int = 3
    serving_breaker_cooldown_s: float = 2.0
    # How often the supervisor runs its repair checks.
    serving_supervisor_interval_s: float = 0.25
    # A stage whose heartbeat is older than this while work is pending is
    # flagged as stalled.
    serving_stage_stall_s: float = 10.0
    # A harvest blocked longer than this is a hung dispatch: the replica
    # is quarantined and its records requeued.
    serving_harvest_deadline_s: float = 30.0
    # Client TTL for records without their own ttl_ms (None: no expiry).
    serving_default_ttl_ms: Optional[float] = None
    # p99 bound on serving_stage_seconds{stage=e2e} for the flight
    # recorder, over serving_slo_window_s windows; 0 disables it.
    serving_slo_p99_ms: float = 0.0
    serving_slo_window_s: float = 5.0
    # Queue transport: "memory", "file" (spool directory, binary framed
    # records), "shm" (shared-memory ring) or "redis" (needs the redis
    # package and a server).
    serving_queue_backend: str = "memory"
    # ShmQueue arena geometry: ring capacity in records and the byte cap
    # per request slot / per result slot.
    serving_shm_slots: int = 256
    serving_shm_slot_bytes: int = 1 << 20
    serving_shm_result_slot_bytes: int = 1 << 20
    # Persistent compile cache directory (deploy/compile_cache.py);
    # empty string = off.
    serving_compile_cache_dir: str = ""
    # Shared device-memory budget for multi-model replica planning
    # (0 = no cap).
    serving_hbm_budget_bytes: int = 0
    # Metrics-driven autoscaler (deploy/autoscale.py).
    serving_autoscale: bool = False
    serving_autoscale_cooldown_s: float = 5.0
    serving_autoscale_interval_s: float = 1.0

    # -- observability ----------------------------------------------------
    # Bounded ring of completed spans kept by observe.TRACER.
    observe_span_ring: int = 4096
    # JSONL event log (spans as they complete + metric dumps); "" = off.
    observe_jsonl_path: str = ""
    # Where flight-recorder snapshots are written; "" = memory only.
    observe_flight_dir: str = ""
    # Arm a short torch.profiler trace when the flight recorder trips
    # (written under observe_flight_dir/profile).
    observe_profile_on_breach: bool = False
    # TensorBoard directory (the serving writer is not ported: setting it
    # for ClusterServing raises).
    tensorboard_dir: Optional[str] = None

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
