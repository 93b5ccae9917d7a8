"""BigDL ``.model`` weights reader (the JAX package's ``bigdl/``)."""

from analytics_zoo_tpu_torch.bigdl.loader import (  # noqa: F401
    BigDLModule,
    import_weights_by_name,
    load_bigdl_weights,
)
