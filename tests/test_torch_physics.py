"""Port parity: the physics step (``ops/engine_v2.py``, ``ops/cuda_engine.py``).

- ``pack_params`` row order equals the JAX ``pack_params`` exactly.
- ``physics_step_plain`` against JAX ``jit(vmap(physics_step_v2))`` at
  n = 8, tolerance 1e-5 (the JAX package's own Pallas test bound). Both
  sides run in float64 (``jax.enable_x64``): in float32 the two frameworks'
  sin/cos differ by an ulp and the contact solve amplifies that, mostly in
  the cube's angular velocity (inverse inertia ~1.8e4); float64 isolates
  the algorithm, which agrees to ~1e-13.
- ``fingertip_components_v2`` in float32 at 1e-6; on CPU tensors the
  fingertip dispatch ``fingertip_components_cuda`` is that function.
The gate sweep is in test_torch_physics_gates.py, the interpret-mode Pallas
case in test_torch_physics_pallas.py, the kernel source's host build in
test_torch_kernel_host.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.ops import cuda_engine, engine_v2
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

TOL = 1e-5
N = 8


def test_pack_params_row_order_matches_reference():
    from leibnizgym_tpu.ops.pallas_engine import _PARAM_FIELDS, pack_params

    assert engine_v2.PARAM_FIELDS == _PARAM_FIELDS
    scene = scene_arrays(N, 0, per_env=True)
    _, _, jp = jax_inputs(random_physics(N, 0), scene, jnp.float32)
    _, _, tp = torch_inputs(random_physics(N, 0), scene, torch.float32)
    np.testing.assert_array_equal(np.asarray(pack_params(jp, N)),
                                  cuda_engine.pack_params(tp, N).numpy())
    # unbatched params broadcast the same way
    np.testing.assert_array_equal(
        np.asarray(pack_params(jtypes.SceneParams.default(), N)),
        cuda_engine.pack_params(ttypes.SceneParams.default(), N).numpy())


def test_scene_defaults_match_reference():
    for shape in ("box", "sphere"):
        ref = jtypes.SceneParams.default(object_shape=shape)
        port = ttypes.SceneParams.default(object_shape=shape)
        for name, value in port.fields().items():
            np.testing.assert_array_equal(np.asarray(getattr(ref, name)), value.numpy(),
                                          err_msg=name)
    assert ttypes.SolverConfig() == ttypes.SolverConfig(
        **{k: getattr(jtypes.SolverConfig(), k)
           for k in ttypes.SolverConfig.__dataclass_fields__})


CASES = {
    # name: (SolverConfig kwargs, object shape, per-env params)
    "pgs_s2_i4": (dict(solver_type=0, substeps=2, solver_iterations=4), "box", False),
    "tgs_s4_i8_per_env_cone_cyl": (dict(solver_type=1, substeps=4, solver_iterations=8),
                                   "box", True),
    "tgs_s2_i4_sphere": (dict(solver_type=1, substeps=2, solver_iterations=4,
                              object_shape=1), "sphere", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_physics_step_plain_matches_engine_v2(case):
    kw, shape, per_env = CASES[case]
    phys = random_physics(N, 3)
    scene = scene_arrays(N, 4, shape=shape, per_env=per_env)
    with jax.enable_x64(True):
        ref_state, ref_wrench = jax.device_get(
            jax_physics_step(jtypes.SolverConfig(**kw))(*jax_inputs(phys, scene, jnp.float64)))
    state, wrench = cuda_engine.physics_step_plain(
        *torch_inputs(phys, scene, torch.float64), ttypes.SolverConfig(**kw), 0.02)
    for name in STATE_FIELDS:
        err = max_diff(getattr(ref_state, name), getattr(state, name))
        assert err < TOL, f"{case} {name}: {err}"
    assert max_diff(ref_wrench, wrench) < TOL


def test_physics_step_cuda_takes_plain_on_cpu():
    """On CPU tensors the kernel wrapper runs the plain version (and counts
    no launch); the packed kernel entry refuses CPU tensors."""
    phys, scene = random_physics(N, 5), scene_arrays(N, 5)
    cfg = ttypes.SolverConfig(substeps=1, solver_iterations=2)
    before = cuda_engine.launch_count
    a = cuda_engine.physics_step_cuda(*torch_inputs(phys, scene, torch.float32), cfg)
    b = cuda_engine.physics_step_plain(*torch_inputs(phys, scene, torch.float32), cfg)
    assert cuda_engine.launch_count == before
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a[0], name), getattr(b[0], name))
    s31 = cuda_engine.pack_state(torch_inputs(phys, scene, torch.float32)[0])
    p40 = torch.zeros((40, N))
    with pytest.raises(ValueError):
        cuda_engine.step_packed_cuda(s31, p40, torch.zeros(9, N), cfg, 0.02)


def test_fingertip_components_cuda_takes_plain_on_cpu():
    """On CPU tensors the fingertip dispatch runs ``fingertip_components_v2``
    (bitwise, no launch counted); the kernel entry refuses CPU tensors."""
    phys = random_physics(N, 7)
    q, qd = torch.as_tensor(phys["q"]), torch.as_tensor(phys["qd"])
    before = cuda_engine.launch_count
    got = cuda_engine.fingertip_components_cuda(q, qd)
    want = engine_v2.fingertip_components_v2(tuple(q[:, i] for i in range(9)),
                                             tuple(qd[:, i] for i in range(9)))
    assert cuda_engine.launch_count == before
    flat_got = [c for finger in got for part in finger for c in part]
    flat_want = [c for finger in want for part in finger for c in part]
    assert len(flat_got) == len(flat_want) == cuda_engine.TIP_ROWS
    assert all(torch.equal(a, b) for a, b in zip(flat_got, flat_want))
    with pytest.raises(ValueError):
        cuda_engine.fingertip_state_cuda(q.T.contiguous(), qd.T.contiguous())


def test_fingertip_components_match_reference():
    from leibnizgym_tpu.ops.engine_v2 import fingertip_components_v2 as jtips

    phys = random_physics(32, 6)
    q, qd = phys["q"], phys["qd"]
    ref = jtips(tuple(jnp.asarray(q[:, i]) for i in range(9)),
                tuple(jnp.asarray(qd[:, i]) for i in range(9)))
    port = engine_v2.fingertip_components_v2(
        tuple(torch.as_tensor(q[:, i]) for i in range(9)),
        tuple(torch.as_tensor(qd[:, i]) for i in range(9)))
    flat_ref = [c for finger in ref for part in finger for c in part]
    flat_port = [c for finger in port for part in finger for c in part]
    assert len(flat_ref) == len(flat_port) == 3 * 13
    for a, b in zip(flat_ref, flat_port):
        assert max_diff(a, b) < 1e-6
