"""Ray-sphere intersection (pure jnp path).

This is the batched descendant of the reference's AVX sweep
(win32-raytracer/RayTracer.cpp:433-589): brute-force ray-vs-all-spheres with
a running nearest-t, streamed over lane-width sphere tiles via ``lax.scan``.
Each 128-sphere tile reduces to its nearest t and first-occurrence winner
(``argmin``), whose packed attribute row is fetched by an exact ``take``
and carried across tiles (a one-hot matrix product would run in TF32 on a
GPU and truncate centres).  The no-hit sentinel is 1e30.

Semantics preserved from the reference: near root only (back faces are a
TODO in the reference too, RayTracer.cpp:496-511), ``discriminant >= 0``,
``t > min_t`` (0.001), strictly-nearer wins so the earliest sphere index is
kept on exact ties (RayTracer.cpp:515, 576-589).  Padded/inactive spheres
are masked, fixing the reference's silent ``size % 8`` sphere dropout
(RayTracer.cpp:432-434).  Motion blur lerps centers by shutter time
(RayTracer.cpp:449-452).  Negative radii flip normals (hollow-glass trick,
RayTracer.cpp:531-533).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import MIN_HIT_T
from ..scene.spheres import SphereScene

# No-hit sentinel (reference: numeric_limits<float>::max, RayTracer.cpp:404).
# A host-side numpy scalar, so jit embeds it as a literal.
F32_MAX = np.float32(1e30)

# Packed attribute-matrix columns (see _attr_matrix).
_A_C1X, _A_C1Y, _A_C1Z = 0, 1, 2
_A_DCX, _A_DCY, _A_DCZ = 3, 4, 5
_A_T1, _A_INVDT, _A_RADIUS = 6, 7, 8
_A_MAT, _A_ALR, _A_ALG, _A_ALB = 9, 10, 11, 12
_A_FUZZ, _A_IOR, _A_IDX = 13, 14, 15
ATTR_COLS = 16


class HitRecord(NamedTuple):
    """Batched analogue of ``ptr::HitRecord`` (RayTracer.cpp:120-127),
    with the winning sphere's material parameters already selected."""

    hit: jnp.ndarray     # [N] bool
    t: jnp.ndarray       # [N] f32 (F32_MAX where no hit)
    point: jnp.ndarray   # [N, 3] f32
    normal: jnp.ndarray  # [N, 3] f32 (flipped for negative radii)
    idx: jnp.ndarray     # [N] int32 winning sphere index (0 where no hit)
    mat_id: jnp.ndarray  # [N] int32
    albedo: jnp.ndarray  # [N, 3] f32
    fuzz: jnp.ndarray    # [N] f32
    ior: jnp.ndarray     # [N] f32


def _attr_matrix(scene: SphereScene) -> jnp.ndarray:
    """Pack per-sphere attributes into one [S, 16] f32 matrix so the winner's
    row can be fetched with a single gather."""
    s = scene.padded_size
    dc = scene.center2 - scene.center1
    idx_f = jnp.arange(s, dtype=jnp.float32)
    return jnp.stack(
        [
            scene.center1[:, 0], scene.center1[:, 1], scene.center1[:, 2],
            dc[:, 0], dc[:, 1], dc[:, 2],
            scene.t1, 1.0 / (scene.t2 - scene.t1), scene.radius,
            scene.mat_id.astype(jnp.float32),
            scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
            scene.fuzz, scene.ior, idx_f,
        ],
        axis=1,
    )


def hit_spheres(
    scene: SphereScene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    time: jnp.ndarray,
    min_t: float = MIN_HIT_T,
    tile: int = 128,
) -> HitRecord:
    """Nearest front-face hit of each ray against every (active) sphere."""
    n = origin.shape[0]
    s = scene.padded_size
    assert s % tile == 0, (s, tile)
    k = s // tile

    tiles = _attr_matrix(scene).reshape(k, tile, ATTR_COLS)      # [K,T,16]
    active = scene.active.astype(jnp.float32).reshape(k, tile)   # [K,T]

    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    a = dx * dx + dy * dy + dz * dz            # [N,1] (d need not be unit)
    tcol = time[:, None]

    # Derive the init carry from the ray inputs (not fresh zeros) so its
    # device-varying type matches the body output under shard_map.
    zero_lane = ox * 0.0                                         # [N,1]
    init = (zero_lane[:, 0] + F32_MAX,
            zero_lane + jnp.zeros((1, ATTR_COLS), jnp.float32))

    def body(carry, args):
        tl, act = args          # tl: [T,16], act: [T]
        best_t, best_a = carry
        # Motion blur: lerp centers by shutter time (RayTracer.cpp:449-452).
        lerp = (tcol - tl[:, _A_T1][None, :]) * tl[:, _A_INVDT][None, :]
        cx = tl[:, _A_C1X][None, :] + tl[:, _A_DCX][None, :] * lerp
        cy = tl[:, _A_C1Y][None, :] + tl[:, _A_DCY][None, :] * lerp
        cz = tl[:, _A_C1Z][None, :] + tl[:, _A_DCZ][None, :] * lerp
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b_half = dx * ocx + dy * ocy + dz * ocz
        r = tl[:, _A_RADIUS][None, :]
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_half * b_half - a * c          # = discriminant / 4
        t = (-b_half - jnp.sqrt(jnp.maximum(disc, 0.0))) / a
        valid = (disc >= 0.0) & (t > min_t) & (act[None, :] > 0.5)
        t = jnp.where(valid, t, F32_MAX)
        # Tile winner: min + first-occurrence argmin (earliest index wins
        # ties, matching RayTracer.cpp:576-589); a later tile must be
        # strictly nearer.
        tile_t = jnp.min(t, axis=1)                              # [N]
        sel = jnp.take(tl, jnp.argmin(t, axis=1), axis=0)        # [N,16]
        better = tile_t < best_t
        return (jnp.where(better, tile_t, best_t),
                jnp.where(better[:, None], sel, best_a)), None

    (best_t, best_a), _ = jax.lax.scan(body, init, (tiles, active))

    hit = best_t < F32_MAX
    t_safe = jnp.where(hit, best_t, 0.0)
    point = origin + t_safe[:, None] * direction

    # Winner's center at ray time; normal = (point - center) / radius
    # (RayTracer.cpp:531-533; signed radius flips hollow-glass normals).
    lerp = (time - best_a[:, _A_T1]) * best_a[:, _A_INVDT]
    center = best_a[:, _A_C1X:_A_C1Z + 1] + best_a[:, _A_DCX:_A_DCZ + 1] * lerp[:, None]
    radius = best_a[:, _A_RADIUS]
    denom = jnp.where(radius == 0.0, 1.0, radius)
    normal = (point - center) / denom[:, None]

    return HitRecord(
        hit=hit,
        t=best_t,
        point=point,
        normal=normal,
        idx=best_a[:, _A_IDX].astype(jnp.int32),
        mat_id=best_a[:, _A_MAT].astype(jnp.int32),
        albedo=best_a[:, _A_ALR:_A_ALB + 1],
        fuzz=best_a[:, _A_FUZZ],
        ior=best_a[:, _A_IOR],
    )
