"""Deployment layer: InferenceModel, the DynamicBatcher and Cluster
Serving (the JAX package's ``deploy/``, less its pod-scale mesh
replicas, image records and the ONNX and TensorFlow loaders: ROADMAP
A4, A8, A9, A10)."""

from analytics_zoo_tpu_torch.deploy.inference import (  # noqa: F401
    LONG_DOC_TOKENS, BatchRequest, DynamicBatcher, InferenceModel,
    ModelReplica, bucket_class, dequantize_pytree, imagenet_preprocess,
    plan_buckets, quantize_pytree, scatter_batch_results)
from analytics_zoo_tpu_torch.deploy.autoscale import (  # noqa: F401
    AutoscalePolicy, Autoscaler)
from analytics_zoo_tpu_torch.deploy.compile_cache import (  # noqa: F401
    CompileCache, CompileCacheCorrupt)
from analytics_zoo_tpu_torch.deploy.codec import (  # noqa: F401
    pack_record, pack_result, packed_nbytes, unpack_record, unpack_result)
from analytics_zoo_tpu_torch.deploy.serving import (  # noqa: F401
    ClusterServing, DeviceExecutor, FileQueue, InputQueue, MemoryQueue,
    OutputQueue, RedisQueue, ServingConfig, decode_tensor, encode_tensor,
    error_payload, make_queue, make_queue_from_zoo)
from analytics_zoo_tpu_torch.deploy.shmqueue import (  # noqa: F401
    ShmQueue, shm_available)
