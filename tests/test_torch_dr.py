"""Port parity: domain randomization (``leibnizgym_tpu_torch/dr``).

The port maps a scene block (n, 7) and a PD-gain block (n, 2) of uniforms;
``reference_dr_draws`` rebuilds those blocks from the reference's keys (the
split layout of ``sample_scene_params`` and ``_masked_full_reset``), and the
port's SceneParams must equal ``leibnizgym_tpu.dr.sample_scene_params`` on
the same key, float32, within 1e-6 relative, with the default ranges and
with overrides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu import dr as jdr
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch import dr as tdr
from leibnizgym_tpu_torch.ops import types as ttypes
from test_torch_common import max_diff

torch.set_num_threads(1)
N = 64
OVERRIDES = {
    "cube_mass_scale": (0.5, 1.5), "cube_size_scale": (0.9, 1.1),
    "link_mass_scale": (0.8, 1.25), "friction_scale": (0.5, 1.5),
    "restitution_range": (0.1, 0.6),
}


def reference_dr_draws(k_dr, n: int):
    """The uniforms behind the reference's ``sample_scene_params(k_dr, ...)``
    and PD gains, as the port's (scene (n, 7), PD (n, 2)) numpy blocks.
    ``k_dr`` is the key ``_masked_full_reset`` splits off its reset key."""
    k_scene, k_pd = jax.random.split(k_dr)
    k_cm, k_cs, k_lm, k_fr, k_re = jax.random.split(k_scene, 5)
    scene = jnp.concatenate([
        jax.random.uniform(k_cm, (n, 1)), jax.random.uniform(k_cs, (n, 1)),
        jax.random.uniform(k_lm, (n, 3)), jax.random.uniform(k_fr, (n, 1)),
        jax.random.uniform(k_re, (n, 1)),
    ], axis=1)
    return np.array(scene), np.array(jax.random.uniform(k_pd, (n, 2)))


def test_reference_draw_layout():
    """The rebuilt draws are the reference's: a (n,) uniform and the first
    column of an (n, 1) one are the same bits."""
    k = jax.random.PRNGKey(3)
    assert np.array_equal(np.asarray(jax.random.uniform(k, (N,))),
                          np.asarray(jax.random.uniform(k, (N, 1)))[:, 0])


@pytest.mark.parametrize("shape", ["box", "sphere"])
@pytest.mark.parametrize("ranges", [None, OVERRIDES], ids=["defaults", "overrides"])
def test_scene_params_match_reference(shape, ranges):
    key = jax.random.PRNGKey(11)
    jbase = jtypes.SceneParams.default(object_shape=shape)
    tbase = ttypes.SceneParams.default(object_shape=shape)
    k_scene = jax.random.split(key)[0]
    ref = jdr.sample_scene_params(k_scene, N, jbase, ranges=ranges)
    u_scene, _ = reference_dr_draws(key, N)
    port = tdr.sample_scene_params_from_uniform(torch.as_tensor(u_scene), tbase, ranges)
    for name, value in port.fields().items():
        r = getattr(ref, name)
        assert tuple(value.shape) == tuple(r.shape), name
        scale = max(1.0, float(np.abs(np.asarray(r)).max()))
        assert max_diff(r, value) <= 1e-6 * scale, name
    # the draws land inside the configured ranges
    lo, hi = (ranges or tdr.DR_DEFAULTS)["cube_mass_scale"]
    m = port.cube_mass / tbase.cube_mass
    assert bool(((m >= lo - 1e-6) & (m <= hi + 1e-6)).all()) and float(m.std()) > 0
    # inertia goes with mass * size^2 for every shape
    s = port.cube_half_extents[:, 0] / tbase.cube_half_extents[0]
    torch.testing.assert_close(port.cube_inertia, tbase.cube_inertia * (m * s * s)[:, None])


def test_pd_scale_matches_reference():
    key = jax.random.PRNGKey(5)
    _, k_pd = jax.random.split(key)
    ref = jax.random.uniform(k_pd, (N, 2), minval=0.9, maxval=1.1)
    _, u_pd = reference_dr_draws(key, N)
    port = tdr.sample_pd_scale_from_uniform(torch.as_tensor(u_pd), (0.9, 1.1))
    assert max_diff(ref, port) <= 1e-6


def test_draw_uniforms_shapes_and_stream():
    g = torch.Generator().manual_seed(0)
    scene, pd = tdr.draw_uniforms(g, N, "cpu")
    assert scene.shape == (N, 7) and pd.shape == (N, 2)
    assert float(scene.min()) >= 0.0 and float(scene.max()) < 1.0
    again = tdr.draw_uniforms(torch.Generator().manual_seed(0), N, "cpu")
    assert torch.equal(scene, again[0]) and torch.equal(pd, again[1])
