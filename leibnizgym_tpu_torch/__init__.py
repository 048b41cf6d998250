"""leibnizgym_tpu_torch: the PyTorch/CUDA port of leibnizgym_tpu.

The JAX package ``leibnizgym_tpu`` is the reference; this package mirrors its
module paths (``ops/``, ``envs/``, ``wrappers/``, ``models/``, ``learning/``)
so each counterpart is easy to find. It imports ``torch`` and never JAX. By
default the physics step runs as a hand-written CUDA kernel
(``csrc/physics_step.cu``) on a CUDA device and as its plain PyTorch version
on the CPU; the env's ``engine`` key also offers the plain version on the
card and the batch-first reference engine (``ops/engine.py``).
"""

__version__ = "0.1.0"
