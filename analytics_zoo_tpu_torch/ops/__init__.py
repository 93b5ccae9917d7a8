"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions,
and the int8 quantization around them (``quantization``: weight
quantization, ``int8_dot``, post-training quantization of programs).

Modules import no kernel library at import time: ``ops._build`` compiles
and loads ``csrc/*.cu`` at the first launch on a CUDA tensor.
"""
