"""Ray-triangle intersection (pure jnp path).

Möller-Trumbore over SoA triangle tiles, structured exactly like the sphere
sweep (ops/hit.py): lax.scan over lane-width tiles, min + first-occurrence
argmin winner, whose packed [16] attribute row is fetched by an exact
gather and carried across tiles.  Two-sided (no backface culling) so dielectric meshes work;
the shading normal is the unit geometric normal, with entering/exiting
resolved by the material math like the sphere path.

Extension component (the reference renders spheres only); the hit contract
matches ``ptr::HitRecord`` semantics: nearest t > min_t wins, earliest
index on ties.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import MIN_HIT_T
from ..scene.triangles import TriangleScene
from .hit import F32_MAX, HitRecord

# Packed triangle attribute columns.
_T_V0X, _T_V0Y, _T_V0Z = 0, 1, 2
_T_E1X, _T_E1Y, _T_E1Z = 3, 4, 5
_T_E2X, _T_E2Y, _T_E2Z = 6, 7, 8
_T_MAT, _T_ALR, _T_ALG, _T_ALB = 9, 10, 11, 12
_T_FUZZ, _T_IOR, _T_IDX = 13, 14, 15
TRI_ATTR_COLS = 16

_DET_EPS = np.float32(1e-9)


def tri_attr_matrix(scene: TriangleScene) -> jnp.ndarray:
    t = scene.padded_size
    idx_f = jnp.arange(t, dtype=jnp.float32)
    return jnp.stack(
        [
            scene.v0[:, 0], scene.v0[:, 1], scene.v0[:, 2],
            scene.e1[:, 0], scene.e1[:, 1], scene.e1[:, 2],
            scene.e2[:, 0], scene.e2[:, 1], scene.e2[:, 2],
            scene.mat_id.astype(jnp.float32),
            scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
            scene.fuzz, scene.ior, idx_f,
        ],
        axis=1,
    )


def hit_triangles(
    scene: TriangleScene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    time: jnp.ndarray,
    min_t: float = MIN_HIT_T,
    tile: int = 128,
) -> HitRecord:
    """Nearest two-sided triangle hit for each ray (time is unused —
    meshes are static; the argument keeps the hit-fn contract)."""
    del time
    n = origin.shape[0]
    s = scene.padded_size
    assert s % tile == 0, (s, tile)
    k = s // tile

    tiles = tri_attr_matrix(scene).reshape(k, tile, TRI_ATTR_COLS)
    active = scene.active.astype(jnp.float32).reshape(k, tile)

    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]

    zero_lane = ox * 0.0
    init = (
        zero_lane[:, 0] + F32_MAX,
        zero_lane + jnp.zeros((1, TRI_ATTR_COLS), jnp.float32),
    )

    def body(carry, args):
        tl, act = args
        best_t, best_a = carry
        e1x, e1y, e1z = (tl[:, _T_E1X][None, :], tl[:, _T_E1Y][None, :],
                         tl[:, _T_E1Z][None, :])
        e2x, e2y, e2z = (tl[:, _T_E2X][None, :], tl[:, _T_E2Y][None, :],
                         tl[:, _T_E2Z][None, :])
        # pvec = d x e2
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, 1.0, det)
        # tvec = o - v0
        tx = ox - tl[:, _T_V0X][None, :]
        ty = oy - tl[:, _T_V0Y][None, :]
        tz = oz - tl[:, _T_V0Z][None, :]
        u = (tx * px + ty * py + tz * pz) * inv_det
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        valid = ((jnp.abs(det) >= _DET_EPS) & (u >= 0.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (t > min_t) & (act[None, :] > 0.5))
        t = jnp.where(valid, t, F32_MAX)

        tile_t = jnp.min(t, axis=1)
        sel = jnp.take(tl, jnp.argmin(t, axis=1), axis=0)

        better = tile_t < best_t
        return (jnp.where(better, tile_t, best_t),
                jnp.where(better[:, None], sel, best_a)), None

    (best_t, best_a), _ = jax.lax.scan(body, init, (tiles, active))

    hit = best_t < F32_MAX
    t_safe = jnp.where(hit, best_t, 0.0)
    point = origin + t_safe[:, None] * direction

    e1 = best_a[:, _T_E1X:_T_E1Z + 1]
    e2 = best_a[:, _T_E2X:_T_E2Z + 1]
    gn = jnp.cross(e1, e2)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(gn * gn, axis=1, keepdims=True),
                                1e-30))
    normal = gn / norm

    return HitRecord(
        hit=hit,
        t=best_t,
        point=point,
        normal=normal,
        idx=best_a[:, _T_IDX].astype(jnp.int32),
        mat_id=best_a[:, _T_MAT].astype(jnp.int32),
        albedo=best_a[:, _T_ALR:_T_ALB + 1],
        fuzz=best_a[:, _T_FUZZ],
        ior=best_a[:, _T_IOR],
    )


def combine_hits(a: HitRecord, b: HitRecord, idx_offset_b: int = 0) -> HitRecord:
    """Nearest of two hit records (e.g. spheres + triangles)."""
    take_b = b.t < a.t
    tb = take_b[:, None]
    return HitRecord(
        hit=a.hit | b.hit,
        t=jnp.where(take_b, b.t, a.t),
        point=jnp.where(tb, b.point, a.point),
        normal=jnp.where(tb, b.normal, a.normal),
        idx=jnp.where(take_b, b.idx + idx_offset_b, a.idx),
        mat_id=jnp.where(take_b, b.mat_id, a.mat_id),
        albedo=jnp.where(tb, b.albedo, a.albedo),
        fuzz=jnp.where(take_b, b.fuzz, a.fuzz),
        ior=jnp.where(take_b, b.ior, a.ior),
    )


def tri_record_rows_from_gather(o, d, t_out, g):
    """HitRecordRows assembly from a rows winner-gather: ``t_out``
    [1, N] nearest t (F32_MAX miss), ``g`` the winner's attr rows
    ([TRI_ATTR_COLS, N], _T_* layout)."""
    from .rows import HitRecordRows

    hit = t_out < F32_MAX
    t_safe = jnp.where(hit, t_out, 0.0)
    point = o + t_safe * d
    e1 = g[_T_E1X:_T_E1X + 3]
    e2 = g[_T_E2X:_T_E2X + 3]
    gx = e1[1:2] * e2[2:3] - e1[2:3] * e2[1:2]
    gy = e1[2:3] * e2[0:1] - e1[0:1] * e2[2:3]
    gz = e1[0:1] * e2[1:2] - e1[1:2] * e2[0:1]
    norm = jnp.sqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, 1e-30))
    normal = jnp.concatenate([gx, gy, gz], axis=0) / norm
    return HitRecordRows(
        hit=hit, t=t_out, point=point, normal=normal,
        idx=g[_T_IDX:_T_IDX + 1].astype(jnp.int32),
        mat_id=g[_T_MAT:_T_MAT + 1].astype(jnp.int32),
        albedo=g[_T_ALR:_T_ALB + 1],
        fuzz=g[_T_FUZZ:_T_FUZZ + 1], ior=g[_T_IOR:_T_IOR + 1],
    )
