"""The kernel's bound: ``cuda_engine.step_flops`` against the reference.

``step_flops(cfg)`` counts the elementwise operations of one control step
of the port's plain version (a ``TorchFunctionMode`` over one
``_substep_fields`` call on one env). Here the same count is taken from the
reference: ``jax.make_jaxpr`` of the JAX package's ``_substep_fields`` on one
env, walking nested jaxprs, each elementwise primitive one op, the solver
loop's body ``solver_iterations`` times. The loop's own counter (one ``add``
per iteration, from ``fori_loop``) is machinery, not physics, and is left
out, and so is the negation of a literal (``-jnp.asarray(0.0)``, the wall
contacts' restitution, which the plain version negates as a Python float):
it is folded into the constant when the step compiles. The two counts must be equal for both solvers, both object shapes and
every gate on and off; ``step_bytes`` and ``bound_ms`` follow from them.
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax.extend.core import Literal
import numpy as np
import pytest

from leibnizgym_tpu.ops import engine_v2 as jev2
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops.types import SolverConfig

# jaxpr primitives that are one elementwise operation each
ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "max", "min", "select_n", "gt", "lt", "ge",
    "le", "eq", "ne", "and", "or", "not", "sqrt", "rsqrt", "sin", "cos", "abs",
    "sign", "integer_pow", "pow", "exp", "log", "clamp",
}


def _count(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "scan":
            body = eqn.params["jaxpr"].jaxpr
            # the fori_loop counter: i + 1 on the loop's first carry
            i = body.invars[eqn.params["num_consts"]]
            counter = sum(1 for e in body.eqns if e.primitive.name == "add"
                          and i in e.invars)
            n += eqn.params["length"] * (_count(body) - counter)
        elif prim == "while":
            raise AssertionError("the solver loop has a static trip count")
        elif prim in ("jit", "pjit", "closed_call", "custom_jvp_call", "custom_vjp_call"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            n += _count(getattr(inner, "jaxpr", inner))
        elif prim in ELEMENTWISE and not (prim == "neg" and isinstance(eqn.invars[0], Literal)):
            n += 1
    return n


def _reference_substep_ops(cfg: SolverConfig) -> int:
    jcfg = jtypes.SolverConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    shape = "sphere" if cfg.object_shape == 1 else "box"
    params = jtypes.SceneParams.default(object_shape=shape)
    state = jtypes.PhysicsState(
        q=jnp.zeros(9), qd=jnp.zeros(9), cube_pos=jnp.zeros(3),
        cube_quat=jnp.array([0.0, 0.0, 0.0, 1.0]), cube_linvel=jnp.zeros(3),
        cube_angvel=jnp.zeros(3))
    h = 0.02 / cfg.substeps
    closed = jax.make_jaxpr(
        lambda s, t, p: jev2._substep_fields(s, t, p, jcfg, h))(state, jnp.zeros(9), params)
    return _count(closed.jaxpr)


GATES = ("cube_wall", "tip_ground", "tip_wall", "link_cube", "torsion")
CASES = {
    **{f"{solver}_{shape}": dict(solver_type=int(solver == "tgs"),
                                  object_shape=int(shape == "sphere"))
       for solver in ("pgs", "tgs") for shape in ("box", "sphere")},
    **{f"{solver}_no_{g}": dict(solver_type=int(solver == "tgs"), **{f"enable_{g}": False})
       for solver in ("pgs", "tgs") for g in GATES},
    "tgs_no_gates": dict(solver_type=1, **{f"enable_{g}": False for g in GATES}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_flops_counts_the_reference(case):
    cfg = SolverConfig(substeps=2, solver_iterations=3, **CASES[case])
    ref = _reference_substep_ops(cfg)
    assert cuda_engine.step_flops(cfg) == cfg.substeps * ref
    assert ref > 1000


def test_step_flops_scales_with_iterations_and_substeps():
    """The sweep counts ``solver_iterations`` times and the step
    ``substeps`` times: the count is linear in both."""
    f = {(s, i): cuda_engine.step_flops(SolverConfig(solver_type=1, substeps=s,
                                                     solver_iterations=i))
         for s in (1, 4) for i in (1, 2, 8)}
    per_iter = f[(1, 2)] - f[(1, 1)]
    assert per_iter > 0 and f[(1, 8)] == f[(1, 1)] + 7 * per_iter
    assert all(f[(4, i)] == 4 * f[(1, i)] for i in (1, 2, 8))


def test_bound_of_the_training_step():
    cfg = SolverConfig(solver_type=1, substeps=4, solver_iterations=8)
    n = 8192
    assert cuda_engine.step_bytes(n) == 4 * n * (31 + 40 + 9 + 31 + 18)
    ms, by = cuda_engine.bound_ms(cfg, n)
    assert by == "operations"
    assert np.isclose(ms, cuda_engine.step_flops(cfg) * n / 67e12 * 1e3)
    # the chain of one env is far longer than the bound allows per op
    assert cuda_engine.step_chain(cfg) > 1000
