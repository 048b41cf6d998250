"""Port parity: the reference engine (``ops/engine.py``) with each
contact-group gate off in turn.

``ops.engine.physics_step`` against the JAX package's
``jit(vmap(ops.engine.physics_step))`` with one ``SolverConfig.enable_*``
gate off at a time (TGS, 2 substeps, 4 iterations, per-env params on both
arenas), both sides in float64, tolerance 1e-5 (see
test_torch_engine_reference.py for why float64).
"""

import pytest
import torch

from test_torch_engine_reference import check_against_jax

torch.set_num_threads(1)

GATES = ("cube_wall", "tip_ground", "tip_wall", "link_cube", "torsion")


@pytest.mark.parametrize("gate", GATES)
def test_gate_off_matches_jax(gate):
    kw = dict(solver_type=1, substeps=2, solver_iterations=4, **{f"enable_{gate}": False})
    check_against_jax(kw, "box", True, 41, gate)
