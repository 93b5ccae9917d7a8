from setuptools import find_packages, setup

setup(
    name="analytics-zoo-tpu",
    version="0.1.0",
    description="TPU-native deep-learning framework (JAX/XLA/Pallas) with "
                "Analytics Zoo capabilities",
    packages=find_packages(include=["analytics_zoo_tpu*",
                                    "analytics_zoo_tpu_torch*"]),
    # the native C++ source ships in the wheel and is compiled lazily on
    # first use (native/__init__.py); without it installed copies would
    # silently fall back to the pure-python paths
    # the PyTorch port's CUDA sources are built with nvcc at first use
    # (analytics_zoo_tpu_torch/ops/_build.py)
    package_data={"analytics_zoo_tpu.native": ["*.cpp"],
                  "analytics_zoo_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
)
