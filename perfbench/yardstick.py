"""The benchmark's fixed arithmetic: the card's published peaks, the work of a
PPO epoch in floating-point operations, and the physics kernel's bound.

None of it reads the program: a later change to the program leaves these
counts where they are, so a share of a peak or a roofline reads the same
work whatever implements it.

Peaks: NVIDIA H100 SXM5 80GB data sheet (NVIDIA, "NVIDIA H100 Tensor Core
GPU", 2023): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3,
at the 700 W power limit. The port's matmuls run in float32 with TF32 off,
PyTorch's default, so 67 TFLOP/s is their peak.

Kernel counts, per env and per launch (one launch per env step: the
configurations step with ``control_decimation`` 1 and the kernel runs the
four substeps inside), frozen from ``ops/cuda_engine.py`` of the program at
the commit that added the benchmark:

- operations: ``step_flops(SolverConfig(substeps=4, solver_iterations=8,
  solver_type=1))`` = 296,212 elementwise operations of the plain step
  (each add, multiply, divide, square root, sine, comparison and select one
  operation), the same for both configurations (their solver settings are
  equal);
- bytes: ``step_bytes(1)`` = 516: state (31 floats), scene params (40) and
  torques (9) read once, state (31) and tip impulses (18) written once, in
  float32.

The configuration files carry these two numbers (``physics_kernel``), so a
configuration with other solver settings brings its own.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAKS_SOURCE = "NVIDIA H100 SXM5 80GB data sheet: 67 TFLOP/s float32 (non-tensor), 3.35 TB/s HBM3, 700 W"


def mlp_macs(in_dim: int, units, out_dim: int) -> int:
    """Multiply-accumulates of one row through a dense tower ``in_dim ->
    units... -> out_dim`` (weights only; the bias adds and activations are
    left out as elementwise work)."""
    dims = [in_dim, *units, out_dim]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def network_macs(obs_dim: int, state_dim: int, action_dim: int, units,
                 central_value: bool) -> tuple[int, int]:
    """(actor-critic, central value) multiply-accumulates per row: the
    actor tower with its ``mu`` head and the critic tower with its value
    head, both on the observation; the central value on the privileged
    state (0 without one)."""
    ac = mlp_macs(obs_dim, units, action_dim) + mlp_macs(obs_dim, units, 1)
    cv = mlp_macs(state_dim, units, 1) if central_value else 0
    return ac, cv


def epoch_model_flops(num_envs: int, horizon: int, ac_macs: int, cv_macs: int,
                      ac_steps: int, ac_rows: int, cv_steps: int, cv_rows: int,
                      kernel_ops_per_env: int) -> float:
    """Floating-point operations of one PPO epoch: the rollout's forward
    passes (``horizon`` policy-and-value passes and the last value's, 2 per
    multiply-accumulate), every minibatch step's forward and backward (3
    forward passes' worth), and the physics kernel's operations, one launch
    per env step."""
    rollout = 2.0 * (ac_macs + cv_macs) * num_envs * (horizon + 1)
    update = 6.0 * (ac_macs * ac_rows * ac_steps + cv_macs * cv_rows * cv_steps)
    physics = float(kernel_ops_per_env) * num_envs * horizon
    return rollout + update + physics


def kernel_bound_s(num_envs: int, ops_per_env: int, bytes_per_env: int) -> tuple[float, str]:
    """(the least time one launch could take at ``num_envs``, which of the
    two bounds sets it): the larger of operations over the float32 peak and
    bytes over the HBM peak."""
    t_ops = ops_per_env * num_envs / PEAK_FP32_FLOPS
    t_bytes = bytes_per_env * num_envs / PEAK_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
