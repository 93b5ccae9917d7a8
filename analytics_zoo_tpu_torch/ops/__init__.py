"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Modules import no kernel library at import time: ``ops._build`` compiles
and loads ``csrc/*.cu`` at the first launch on a CUDA tensor.
"""
