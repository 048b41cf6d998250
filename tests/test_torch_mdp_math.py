"""Port parity: ``utils/mdp.py`` (``Transition``, the re-exported
``RewardTermSpec``) and the 3x3 helpers of ``utils/math.py`` that the
dynamics use (``skew``, ``solve_pd_3x3``) against the JAX package.

The math runs in float64 on both sides (``jax.enable_x64``) on the same
seeded numpy inputs, held at 1e-12: the same formulas in the same order,
so only the last ulps may differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from leibnizgym_tpu.envs.trifinger import rewards as jrewards
from leibnizgym_tpu.utils import math as jmath
from leibnizgym_tpu.utils import mdp as jmdp
from leibnizgym_tpu_torch.envs.trifinger import rewards as trewards
from leibnizgym_tpu_torch.utils import math as tmath
from leibnizgym_tpu_torch.utils import mdp as tmdp


def test_transition_has_the_reference_fields():
    names = [f.name for f in dataclasses.fields(tmdp.Transition)]
    assert names == [f.name for f in dataclasses.fields(jmdp.Transition)]
    t = tmdp.Transition(obs=torch.zeros(2, 41), states=torch.zeros(2, 113),
                        reward=torch.zeros(2), done=torch.zeros(2, dtype=torch.bool),
                        info={"x": torch.ones(2)})
    assert t.obs.shape == (2, 41) and t.info["x"].sum() == 2


def test_reward_term_spec_is_the_ports_and_matches_the_reference():
    assert tmdp.RewardTermSpec is trewards.RewardTermSpec
    assert [f.name for f in dataclasses.fields(tmdp.RewardTermSpec)] == \
        [f.name for f in dataclasses.fields(jrewards.RewardTermSpec)]


def test_skew_and_solve_pd_3x3_match_reference():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((5, 4, 3))
    a = rng.standard_normal((5, 4, 3, 3))
    spd = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3)
    b = rng.standard_normal((5, 4, 3))
    with jax.enable_x64(True):
        jskew = np.asarray(jmath.skew(jnp.asarray(v)))
        jx = np.asarray(jmath.solve_pd_3x3(jnp.asarray(spd), jnp.asarray(b)))
    tskew = tmath.skew(torch.as_tensor(v)).numpy()
    tx = tmath.solve_pd_3x3(torch.as_tensor(spd), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(tskew, jskew)
    assert np.abs(tx - jx).max() < 1e-12
    assert np.abs(spd @ tx[..., None] - b[..., None]).max() < 1e-9  # it solves
