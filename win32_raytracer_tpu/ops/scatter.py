"""Wavefront material scatter.

The batched, masked-lane equivalent of the material branches inside the
reference's recursive ``getColor`` (win32-raytracer/RayTracer.cpp:604-688).
All three materials are evaluated for every lane and the results selected by
material id — branchless, as wide hardware wants it.  Semantics preserved exactly:

* Lambertian (RayTracer.cpp:604-617): target = hit + normal + ball-point;
  origin offset by EPSILON along the normal; attenuation = albedo.
* Metal (RayTracer.cpp:618-635): reflect the *unnormalized* incoming
  direction, add fuzz * ball-point; if the scattered dir points into the
  surface the ray is absorbed (contributes black).
* Dielectric (RayTracer.cpp:636-688), quirks included: Schlick called with
  ni_over_nt (not the IOR), reflect decision ``REFLECT_THRES + r < prob``,
  refract with the 2.0 discriminant, attenuation (1,1,1), and the exact
  origin-offset signs of each branch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import RenderConfig
from ..core import materials as mat
from ..core.vec import dot, normalize
from ..core.rng import sample_unit_ball
from ..scene.spheres import SphereScene
from .hit import HitRecord


class ScatterResult(NamedTuple):
    origin: jnp.ndarray       # [N, 3] new ray origin
    direction: jnp.ndarray    # [N, 3] new ray direction (unnormalized)
    attenuation: jnp.ndarray  # [N, 3] throughput multiplier
    alive: jnp.ndarray        # [N] bool — False = absorbed (black)


def scatter(
    scene: SphereScene,
    direction: jnp.ndarray,
    hit: HitRecord,
    draws: jnp.ndarray,
    cfg: RenderConfig,
) -> ScatterResult:
    """One scatter event for every lane.

    ``draws`` is [N, 4]: 3 uniforms for the unit-ball sample + 1 for the
    dielectric reflect decision.  Material params ride in the HitRecord
    (selected during the hit sweep, so scatter reads no scene arrays).
    """
    eps = jnp.float32(cfg.epsilon)
    mat_id, albedo, fuzz, ior = hit.mat_id, hit.albedo, hit.fuzz, hit.ior
    n = hit.normal
    hp = hit.point
    ball = sample_unit_ball(draws[:, 0:3])

    # --- Lambertian (RayTracer.cpp:604-617) ---------------------------------
    lam_origin = hp + eps * n
    # (hit + normal + ball) - (hit + eps*normal) = (1-eps)*normal + ball
    lam_dir = (1.0 - eps) * n + ball
    lam_att = albedo

    # --- Metal (RayTracer.cpp:618-635) --------------------------------------
    met_dir = mat.reflect(direction, n) + fuzz[:, None] * ball
    met_ok = dot(met_dir, n) > 0.0      # else absorbed -> black
    met_origin = hp + eps * n
    met_att = albedo

    # --- Dielectric (RayTracer.cpp:636-688) ---------------------------------
    dir_to_light = normalize(-direction)
    inv_ray_dot_n = dot(dir_to_light, n)
    entering = inv_ray_dot_n > 0.0
    ni_over_nt = jnp.where(entering, 1.0 / ior, ior)
    rfn = jnp.where(entering[:, None], n, -n)       # ray-facing normal
    offset = eps * n
    refract_offset = jnp.where(entering[:, None], -offset, offset)

    cosine = dot(dir_to_light, rfn)
    schlick_arg = ni_over_nt if cfg.schlick_uses_ni_over_nt else ior
    reflect_prob = mat.schlick(cosine, schlick_arg)
    is_reflected = (cfg.reflect_thres + draws[:, 3]) < reflect_prob

    refr_dir, refr_ok = mat.refract(
        -direction, rfn, ni_over_nt, cfg.refract_discriminant_bias
    )
    refl_dir = mat.reflect(direction, n)       # Schlick-reflection branch
    tir_dir = mat.reflect(direction, rfn)      # TIR fallback branch

    die_dir = jnp.where(
        is_reflected[:, None],
        refl_dir,
        jnp.where(refr_ok[:, None], refr_dir, tir_dir),
    )
    die_origin = jnp.where(
        (is_reflected | ~refr_ok)[:, None],
        hp - refract_offset,
        hp + refract_offset,
    )
    die_att = jnp.ones_like(albedo)  # attenuation (1,1,1), RayTracer.cpp:641

    # --- Select by material id ----------------------------------------------
    is_met = (mat_id == mat.METAL)[:, None]
    is_die = (mat_id == mat.DIELECTRIC)[:, None]

    new_origin = jnp.where(is_die, die_origin, jnp.where(is_met, met_origin, lam_origin))
    new_dir = jnp.where(is_die, die_dir, jnp.where(is_met, met_dir, lam_dir))
    att = jnp.where(is_die, die_att, jnp.where(is_met, met_att, lam_att))
    alive = jnp.where(mat_id == mat.METAL, met_ok, True)

    return ScatterResult(origin=new_origin, direction=new_dir,
                         attenuation=att, alive=alive)
