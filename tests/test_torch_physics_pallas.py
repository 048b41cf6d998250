"""Port parity: the plain physics step against the TPU kernel itself.

One TGS case against ``physics_step_pallas`` in interpret mode, as
tests/test_physics.py runs it on the CPU (interpret mode pads to 1024 envs,
so one case only). The kernel writes float32, so this case is float32 on
both sides: 1e-5 on joint angles, cube position and orientation; 1e-4 on
velocities and the wrench, where the sin/cos ulp differences of the two
frameworks are amplified by the contact solve (measured 3.2e-5 on the
cube's angular velocity).
"""

import jax
import jax.numpy as jnp
import torch

from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops import types as ttypes
from test_torch_common import (
    STATE_FIELDS,
    jax_inputs,
    max_diff,
    random_physics,
    scene_arrays,
    torch_inputs,
)

torch.set_num_threads(1)

N = 8


def test_plain_matches_pallas_kernel_interpret():
    from leibnizgym_tpu.ops.pallas_engine import physics_step_pallas

    kw = dict(substeps=2, solver_iterations=4, solver_type=1)
    phys = random_physics(N, 3)
    scene = scene_arrays(N, 3)
    ref_state, ref_wrench = jax.device_get(physics_step_pallas(
        *jax_inputs(phys, scene, jnp.float32), jtypes.SolverConfig(**kw), 0.02,
        interpret=True))
    state, wrench = cuda_engine.physics_step_plain(
        *torch_inputs(phys, scene, torch.float32), ttypes.SolverConfig(**kw), 0.02)
    tol = {"q": 1e-5, "cube_pos": 1e-5, "cube_quat": 1e-5,
           "qd": 1e-4, "cube_linvel": 1e-4, "cube_angvel": 1e-4}
    for name in STATE_FIELDS:
        err = max_diff(getattr(ref_state, name), getattr(state, name))
        assert err < tol[name], f"{name}: {err}"
    assert max_diff(ref_wrench, wrench) < 1e-4
