"""Lane-major ("rows") wavefront layout: vectors are [3, N], scalars [1, N].

With lanes minor ([C, N]), every field a step reads is a contiguous row
slice, and the sphere kernel reads its rays and writes its results in the
same layout with no repacking.

This module holds the rows-layout equivalents of ops.hit / ops.scatter /
scene.camera.camera_rays / core.materials.sky_color, with identical
semantics (all the reference quirks preserved — see the column modules for
the RayTracer.cpp line citations).  The column layout remains the public
API at chunk boundaries; the persistent scheduler runs on rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp

from ..config import RenderConfig
from ..core import materials as mat
from ..scene.camera import Camera
from .hit import (
    F32_MAX, HitRecord, _A_ALB, _A_ALR, _A_C1X, _A_C1Z, _A_DCX, _A_DCZ,
    _A_FUZZ, _A_IDX, _A_INVDT, _A_IOR, _A_MAT, _A_RADIUS, _A_T1,
)


class HitRecordRows(NamedTuple):
    """HitRecord in rows layout (ops.hit.HitRecord transposed)."""

    hit: jnp.ndarray     # [1, N] bool
    t: jnp.ndarray       # [1, N] f32
    point: jnp.ndarray   # [3, N] f32
    normal: jnp.ndarray  # [3, N] f32
    idx: jnp.ndarray     # [1, N] int32
    mat_id: jnp.ndarray  # [1, N] int32
    albedo: jnp.ndarray  # [3, N] f32
    fuzz: jnp.ndarray    # [1, N] f32
    ior: jnp.ndarray     # [1, N] f32


def rdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[3, N] . [3, N] -> [1, N]."""
    return jnp.sum(a * b, axis=0, keepdims=True)


def combine_hits_rows(a: HitRecordRows, b: HitRecordRows,
                      idx_offset_b: int = 0) -> HitRecordRows:
    """Nearest of two rows hit records (ops.hit_tri.combine_hits in rows:
    strict b.t < a.t, so geometry A wins exact ties like the column
    path)."""
    take_b = b.t < a.t
    return HitRecordRows(
        hit=a.hit | b.hit,
        t=jnp.where(take_b, b.t, a.t),
        point=jnp.where(take_b, b.point, a.point),
        normal=jnp.where(take_b, b.normal, a.normal),
        idx=jnp.where(take_b, b.idx + idx_offset_b, a.idx),
        mat_id=jnp.where(take_b, b.mat_id, a.mat_id),
        albedo=jnp.where(take_b, b.albedo, a.albedo),
        fuzz=jnp.where(take_b, b.fuzz, a.fuzz),
        ior=jnp.where(take_b, b.ior, a.ior),
    )


def assemble_hit_record_rows(origin, direction, time, best_t, gt
                             ) -> HitRecordRows:
    """HitRecordRows from the winner's attribute rows ``gt`` [16, N]
    (ops.hit._attr_matrix columns as rows; zeros on a miss)."""
    hit = best_t < F32_MAX
    t_safe = jnp.where(hit, best_t, 0.0)
    point = origin + t_safe * direction
    lerp = (time - gt[_A_T1:_A_T1 + 1]) * gt[_A_INVDT:_A_INVDT + 1]
    center = gt[_A_C1X:_A_C1Z + 1] + gt[_A_DCX:_A_DCZ + 1] * lerp
    radius = gt[_A_RADIUS:_A_RADIUS + 1]
    denom = jnp.where(radius == 0.0, 1.0, radius)
    normal = (point - center) / denom
    return HitRecordRows(
        hit=hit, t=best_t, point=point, normal=normal,
        idx=gt[_A_IDX:_A_IDX + 1].astype(jnp.int32),
        mat_id=gt[_A_MAT:_A_MAT + 1].astype(jnp.int32),
        albedo=gt[_A_ALR:_A_ALB + 1],
        fuzz=gt[_A_FUZZ:_A_FUZZ + 1], ior=gt[_A_IOR:_A_IOR + 1],
    )


def rnormalize(a: jnp.ndarray) -> jnp.ndarray:
    return a / jnp.maximum(jnp.sqrt(rdot(a, a)), 1e-37)


def sky_color_rows(d: jnp.ndarray) -> jnp.ndarray:
    """[3, N] dirs -> [3, N] sky gradient (RayTracer.cpp:690-701)."""
    t = 0.5 * (rnormalize(d)[1:2] + 1.0)                 # [1, N]
    white = jnp.ones((3, 1), jnp.float32)
    tint = jnp.asarray([[0.5], [0.7], [1.0]], jnp.float32)
    return (1.0 - t) * white + t * tint


def reflect_rows(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    return v - 2.0 * rdot(v, n) * n


def refract_rows(d, n, ni_over_nt, discriminant_bias):
    nd = rnormalize(d)
    dt = rdot(nd, n)
    disc = discriminant_bias - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    refr = (ni_over_nt * (nd - n * dt)
            - n * jnp.sqrt(jnp.maximum(disc, 0.0)))
    return refr, ok


def sample_unit_ball_rows(u: jnp.ndarray) -> jnp.ndarray:
    """u [3, N] uniforms -> [3, N] points uniform in the unit ball
    (same map as core.rng.sample_unit_ball)."""
    z = 1.0 - 2.0 * u[0:1]
    phi = (2.0 * jnp.pi) * u[1:2]
    # exp(log(x)/3) rather than cbrt, like core.rng.sample_unit_ball
    # (log(0) -> -inf -> exp -> 0 handles the endpoint).
    r = jnp.exp(jnp.log(u[2:3]) * (1.0 / 3.0))
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.concatenate([r * s * jnp.cos(phi), r * s * jnp.sin(phi), r * z])


def camera_rays_rows(cam: Camera, u: jnp.ndarray, v: jnp.ndarray,
                     draws: jnp.ndarray):
    """Rows version of scene.camera.camera_rays: u/v [1, N], draws [3, N]
    -> (origin [3, N], direction [3, N], time [1, N]).

    Camera vector fields may be [3] (one camera) or pre-broadcast [3, N]
    row operands (per-lane cameras, persistent multi-frame batching)."""
    def col(f):
        return f[:, None] if f.ndim == 1 else f

    time = cam.shutter_open + (cam.shutter_close - cam.shutter_open) * draws[0:1]
    r = jnp.sqrt(draws[1:2]) * cam.lens_radius
    theta = (2.0 * jnp.pi) * draws[2:3]
    offset = (col(cam.right_axis) * (r * jnp.cos(theta))
              + col(cam.up_axis) * (r * jnp.sin(theta)))
    origin = col(cam.origin) + offset
    direction = (col(cam.lower_left_corner)
                 + u * col(cam.horizontal)
                 + v * col(cam.vertical)
                 - origin)
    return origin, direction, time


class ScatterRowsResult(NamedTuple):
    origin: jnp.ndarray       # [3, N]
    direction: jnp.ndarray    # [3, N]
    attenuation: jnp.ndarray  # [3, N]
    alive: jnp.ndarray        # [1, N] bool


def scatter_rows(
    direction: jnp.ndarray,   # [3, N] incoming
    hit: HitRecordRows,
    draws: jnp.ndarray,       # [5, N]
    cfg: RenderConfig,
) -> ScatterRowsResult:
    """Rows-layout ops.scatter.scatter — identical semantics/quirks
    (RayTracer.cpp:604-688 via ops/scatter.py)."""
    eps = jnp.float32(cfg.epsilon)
    n, hp = hit.normal, hit.point
    albedo = hit.albedo
    ball = sample_unit_ball_rows(draws[0:3])

    # Lambertian (RayTracer.cpp:604-617).
    lam_origin = hp + eps * n
    lam_dir = (1.0 - eps) * n + ball
    # Metal (RayTracer.cpp:618-635).
    met_dir = reflect_rows(direction, n) + hit.fuzz * ball
    met_ok = rdot(met_dir, n) > 0.0
    met_origin = hp + eps * n
    # Dielectric (RayTracer.cpp:636-688), quirks included.
    dir_to_light = rnormalize(-direction)
    entering = rdot(dir_to_light, n) > 0.0
    ni_over_nt = jnp.where(entering, 1.0 / hit.ior, hit.ior)
    rfn = jnp.where(entering, n, -n)
    offset = eps * n
    refract_offset = jnp.where(entering, -offset, offset)

    cosine = rdot(dir_to_light, rfn)
    schlick_arg = ni_over_nt if cfg.schlick_uses_ni_over_nt else hit.ior
    reflect_prob = mat.schlick(cosine, schlick_arg)
    is_reflected = (cfg.reflect_thres + draws[3:4]) < reflect_prob

    refr_dir, refr_ok = refract_rows(-direction, rfn, ni_over_nt,
                                     cfg.refract_discriminant_bias)
    refl_dir = reflect_rows(direction, n)
    tir_dir = reflect_rows(direction, rfn)

    die_dir = jnp.where(is_reflected, refl_dir,
                        jnp.where(refr_ok, refr_dir, tir_dir))
    die_origin = jnp.where(is_reflected | ~refr_ok,
                           hp - refract_offset, hp + refract_offset)

    is_met = hit.mat_id == mat.METAL
    is_die = hit.mat_id == mat.DIELECTRIC
    new_origin = jnp.where(is_die, die_origin,
                           jnp.where(is_met, met_origin, lam_origin))
    new_dir = jnp.where(is_die, die_dir, jnp.where(is_met, met_dir, lam_dir))
    att = jnp.where(is_die, 1.0, albedo)
    alive = jnp.where(is_met, met_ok, True)
    return ScatterRowsResult(origin=new_origin, direction=new_dir,
                             attenuation=att, alive=alive)


@functools.lru_cache(maxsize=None)
def hit_rows_adapter(column_hit_fn):
    """Wrap a column-layout hit function (ops.hit signature) into the rows
    interface (the plain sweeps and non-sphere scenes; the GPU sphere
    kernel is rows-native).  Cached: hit functions are static jit arguments
    downstream, so the same wrapper object must be returned per input."""
    def rows_fn(scene, o_r, d_r, t_r, min_t=0.001):
        rec: HitRecord = column_hit_fn(scene, o_r.T, d_r.T, t_r[0],
                                       min_t=min_t)
        return HitRecordRows(
            hit=rec.hit[None], t=rec.t[None], point=rec.point.T,
            normal=rec.normal.T, idx=rec.idx[None], mat_id=rec.mat_id[None],
            albedo=rec.albedo.T, fuzz=rec.fuzz[None], ior=rec.ior[None])
    return rows_fn
