"""ONNX import (the JAX package's ``onnx/``): a pure-python wire-format
codec (``proto.py``) and the op lowering to torch (``loader.py``); no
``onnx`` package is needed."""

from analytics_zoo_tpu_torch.onnx.loader import (  # noqa: F401
    OnnxProgram, UnsupportedOnnxOp, load_onnx, load_onnx_bytes, to_model)

__all__ = ["load_onnx", "load_onnx_bytes", "to_model", "OnnxProgram",
           "UnsupportedOnnxOp"]
