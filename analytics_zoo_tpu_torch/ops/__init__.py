"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions,
and the int8 quantization around them (``quantization``: weight
quantization, ``int8_dot``, post-training quantization of programs).

Modules import no kernel library at import time: ``ops._build`` compiles
and loads ``csrc/*.cu`` at the first launch on a CUDA tensor.

The package exports the JAX package's ``ops`` names, each loaded on first
use.  ``embedding_bag``, ``dequant_matmul`` and ``flash_attention`` are
functions there and modules here: each module is callable as its
namesake function (``dispatch.callable_module``), so
``ops.embedding_bag(table, ids)`` and ``ops.embedding_bag.bag_layout``
both work.
"""

_LAZY = {
    "blockwise_attention": "attention",
    "dot_product_attention": "attention",
    "reference_attention": "attention",
    "dequant_matmul_reference": "dequant_matmul",
    "pack_int4": "dequant_matmul",
    "quantize_weights": "dequant_matmul",
    "unpack_int4": "dequant_matmul",
    "select_path": "dispatch",
    "embedding_bag_reference": "embedding_bag",
    "Calibrator": "quantization",
    "int8_dot": "quantization",
    "quantize_program": "quantization",
    "quantize_tensor": "quantization",
}
# the modules that are also their namesake functions
_CALLABLE = ("dequant_matmul", "embedding_bag", "flash_attention")


def __getattr__(name):
    import importlib

    if name in _CALLABLE:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                    name)
    globals()[name] = value
    return value
