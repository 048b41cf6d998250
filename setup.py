"""Package setup for leibnizgym_tpu."""

from setuptools import find_packages, setup

setup(
    name="leibnizgym_tpu",
    version="0.1.0",
    description=(
        "TPU-native TriFinger RL environment suite: batched JAX rigid-body "
        "physics, TriFinger cube-manipulation task, PPO training stack"
    ),
    # leibnizgym_tpu_torch: the PyTorch/CUDA port (needs torch; its CUDA
    # kernel is built from csrc/*.cu with nvcc at first use on a GPU)
    packages=find_packages(include=[
        "leibnizgym_tpu", "leibnizgym_tpu.*",
        "leibnizgym_tpu_torch", "leibnizgym_tpu_torch.*",
    ]),
    package_data={"leibnizgym_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "chex",
        "numpy",
        "pyyaml",
        "termcolor",
        "scipy",
    ],
    extras_require={
        "test": ["pytest"],
        "logging": ["tensorboardX"],
    },
)
