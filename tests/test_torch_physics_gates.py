"""Port parity: each contact-group gate off in turn.

``physics_step_plain`` against JAX ``jit(vmap(physics_step_v2))`` with one
``SolverConfig.enable_*`` gate off at a time (TGS, 2 substeps, 4
iterations, per-env params), both sides in float64, tolerance 1e-5 (see
test_torch_physics.py for why float64). The case against the TPU kernel
itself is in test_torch_physics_pallas.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops import types as ttypes
from test_torch_common import (
    STATE_FIELDS,
    jax_inputs,
    jax_physics_step,
    max_diff,
    random_physics,
    scene_arrays,
    torch_inputs,
)

torch.set_num_threads(1)

N = 8
GATES = ("cube_wall", "tip_ground", "tip_wall", "link_cube", "torsion")


@pytest.mark.parametrize("gate", GATES)
def test_gate_off_matches_engine_v2(gate):
    kw = dict(solver_type=1, substeps=2, solver_iterations=4, **{f"enable_{gate}": False})
    phys = random_physics(N, 11)
    scene = scene_arrays(N, 12, per_env=True)
    with jax.enable_x64(True):
        ref_state, ref_wrench = jax.device_get(
            jax_physics_step(jtypes.SolverConfig(**kw))(*jax_inputs(phys, scene, jnp.float64)))
    state, wrench = cuda_engine.physics_step_plain(
        *torch_inputs(phys, scene, torch.float64), ttypes.SolverConfig(**kw), 0.02)
    for name in STATE_FIELDS:
        err = max_diff(getattr(ref_state, name), getattr(state, name))
        assert err < 1e-5, f"{gate} {name}: {err}"
    assert max_diff(ref_wrench, wrench) < 1e-5
