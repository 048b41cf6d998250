"""Robot and object constants of the TriFinger platform.

These are the JAX package's tables (``leibnizgym_tpu/models/trifinger.py``),
a module of plain numpy that imports no JAX. The port reads them from
there, so that one table feeds both packages and the CUDA kernel's
constants (``ops/cuda_engine.kernel_consts``).
"""

from leibnizgym_tpu.models.trifinger import *  # noqa: F401,F403
