from analytics_zoo_tpu_torch.deploy.inference import (  # noqa: F401
    DynamicBatcher,
    InferenceModel,
    dequantize_pytree,
    plan_buckets,
    quantize_pytree,
)
