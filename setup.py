"""Packaging (reference analog: setup.py — pip package with loader deps).

The dependency set is the TPU stack (jax + pyarrow) instead of the
reference's ray/pandas/torch (reference: setup.py:14-20); torch is an
extra for the migration-compat Torch binding.
"""

from setuptools import find_packages, setup

setup(
    name="ray_shuffling_data_loader_tpu",
    version="0.1.0",
    description=("TPU-native pipelined per-epoch distributed shuffling "
                 "data loader for JAX"),
    packages=find_packages(
        include=["ray_shuffling_data_loader_tpu",
                 "ray_shuffling_data_loader_tpu.*",
                 "ray_shuffling_data_loader_tpu_torch",
                 "ray_shuffling_data_loader_tpu_torch.*"]),
    package_data={
        "ray_shuffling_data_loader_tpu.native": ["src/*.cpp"],
        "ray_shuffling_data_loader_tpu_torch.kernels": ["*.cu", "*.cuh"],
        "ray_shuffling_data_loader_tpu_torch.native": ["src/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pyarrow",
    ],
    extras_require={
        "torch": ["torch"],
        "models": ["flax", "optax"],
    },
)
