"""Domain randomization: per-env physics parameters redrawn at reset
(counterpart of ``leibnizgym_tpu/dr/__init__.py``).

A randomized reset draws two uniform blocks in [0, 1) and maps them with
pure functions, so a test can feed the reference's draws:

- the scene block (n, 7), columns
    0    cube mass scale       reference key ``k_cm``, shape (n,)
    1    cube size scale       ``k_cs``, (n,)
    2:5  link mass scales      ``k_lm``, (n, 3)
    5    friction scale        ``k_fr``, (n,)
    6    tip-cube restitution  ``k_re``, (n,)
  the five keys of ``split(k_dr, 5)`` in ``sample_scene_params`` (dr:42),
  where ``_masked_full_reset`` made ``k_dr`` by ``key, k_dr = split(key)``
  and then ``k_dr, k_pd = split(k_dr)`` (env.py:813-815, 854);
- the PD-gain block (n, 2), scales of (kp, kd), from ``k_pd``
  (env.py:865-866).

A value is ``u * (hi - lo) + lo``, as ``jax.random.uniform`` maps its bits.
"""

from __future__ import annotations

import torch

from perfbench.reference.types import SceneParams

# default randomization ranges (multiplicative scales unless noted)
DR_DEFAULTS = {
    "cube_mass_scale": (0.8, 1.2),
    "cube_size_scale": (0.97, 1.03),
    "link_mass_scale": (0.9, 1.1),
    "friction_scale": (0.7, 1.3),
    "restitution_range": (0.0, 0.8),  # absolute, tip-cube pair
}

N_SCENE = 7
N_PD = 2


def draw_uniforms(generator: torch.Generator, n: int, device, dtype=torch.float32):
    """(scene block (n, 7), PD-gain block (n, 2)) from ``generator``."""
    u = torch.rand((n, N_SCENE + N_PD), generator=generator, device=device, dtype=dtype)
    return u[:, :N_SCENE], u[:, N_SCENE:]


def _lerp(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return u * (hi - lo) + lo


def sample_scene_params_from_uniform(u: torch.Tensor, base: SceneParams,
                                     ranges: dict | None = None) -> SceneParams:
    """``n`` randomized SceneParams around ``base`` (unbatched) from the
    scene block ``u`` (n, 7). Inertia scales as mass * size^2, which keeps
    the object's declared inertia at scale 1 for any shape; one friction
    scale multiplies all six friction coefficients (not torsion)."""
    r = dict(DR_DEFAULTS)
    if ranges:
        r.update({k: tuple(v) for k, v in ranges.items() if k in DR_DEFAULTS})
    n = u.shape[0]
    mass_scale = _lerp(u[:, 0], *r["cube_mass_scale"])
    size_scale = _lerp(u[:, 1], *r["cube_size_scale"])
    link_scale = _lerp(u[:, 2:5], *r["link_mass_scale"])
    fric = _lerp(u[:, 5], *r["friction_scale"])
    restitution = _lerp(u[:, 6], *r["restitution_range"])
    scaled = {
        "cube_mass": base.cube_mass * mass_scale,
        "cube_half_extents": base.cube_half_extents * size_scale[:, None],
        "cube_inertia": base.cube_inertia * (mass_scale * size_scale**2)[:, None],
        "link_masses": base.link_masses * link_scale,
        "restitution_tip_cube": restitution,
        **{k: getattr(base, k) * fric for k in (
            "mu_tip_cube", "mu_cube_ground", "mu_cube_wall", "mu_tip_ground",
            "mu_tip_wall", "mu_link_cube")},
    }
    return SceneParams(**{
        k: scaled[k] if k in scaled else v.expand((n,) + tuple(v.shape))
        for k, v in base.fields().items()
    })


def sample_pd_scale_from_uniform(u: torch.Tensor, pd_gain_scale) -> torch.Tensor:
    """Per-env (kp, kd) scales (n, 2) from the PD-gain block ``u`` (n, 2)."""
    return _lerp(u, *pd_gain_scale)
