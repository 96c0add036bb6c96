"""Uniform-grid (Morton-tiled) acceleration for the triangle sweep.

The brute Möller-Trumbore sweep (ops/hit_tri.py) tests every ray against
every triangle, which scales linearly in triangle count (BASELINE config 4
asks for a >=10k-triangle mesh).  This is the triangle analogue of the
sphere grid (accel.py), with the same block-uniform control flow:

* Triangles are sorted by the **Morton code** of their centroid, then cut
  into tiles of ``tile_rows`` contiguous triangles — spatial sorting makes
  each tile's AABB compact.  Within a tile, members are re-sorted by
  original index so within-tile ties resolve to the earliest index, like
  the brute sweep.
* Per ray: clip to the grid's scene AABB (slab test) and to ``t_cap``
  (the nearest hit from a cheaper pass — e.g. the sphere sweep in a
  composite scene — occludes anything farther); the surviving t-segment
  sweeps a per-ray 3D box.
* Per ray **block**: min/max-reduce the ray boxes, then test the block
  box against every tile AABB — a [NB, T] conservative mask.

Conservative by construction: a tile is skipped only when NO ray in the
block can reach its AABB at an unoccluded t.  The winning hit is
numerically identical to the brute sweep up to the cross-tile tie rule
(tile visit order; measure-zero for real geometry).  The sweep here is
plain XLA: it computes masked tiles and discards them, so the mask
verifies the structure (and feeds the rebin/DDA sort keys) rather than
saving work.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax.numpy as jnp

from .config import MIN_HIT_T
from .ops.hit_tri import (
    TRI_ATTR_COLS, _DET_EPS, _T_V0X, _T_E1X, _T_E2X, _T_MAT, _T_ALR,
    _T_ALB, _T_FUZZ, _T_IOR, _T_IDX,
)
from .ops.hit import F32_MAX
from .scene.triangles import TriangleScene

_BIG = np.float32(1e8)


class TriGridScene(NamedTuple):
    """A TriangleScene plus its Morton-tiled acceleration arrays.

    Drop-in ``scene`` for the render paths (scatter ignores scene fields;
    material params ride in the HitRecord).  ``base`` is untouched so the
    brute sweep keeps working on it."""

    base: TriangleScene
    tile_attrs: jnp.ndarray   # [T * St, TRI_ATTR_COLS], tile-major
    tile_boxes: jnp.ndarray   # [T, 6] f32: x0, x1, y0, y1, z0, z1
    scene_box: jnp.ndarray    # [6] f32 union of tile boxes

    @property
    def padded_size(self) -> int:
        return self.base.padded_size

    @property
    def n_tiles(self) -> int:
        return self.tile_boxes.shape[0]

    @property
    def tile_rows(self) -> int:
        return self.tile_attrs.shape[0] // self.tile_boxes.shape[0]


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three integer grids into Morton codes (u32-safe).
    Quantization granularity is the caller's clamp (1023 at the call
    site); the spread handles up to 21 bits per axis."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v
    return (spread(x) | (spread(y) << np.uint64(1))
            | (spread(z) << np.uint64(2)))


# Built grids memoized by the identity of the TriangleScene: the hit
# dispatcher resolves accel per render call, and the host-side build is a
# Python loop over tiles.  Values hold a strong ref to the scene
# (grid.base), so the id key cannot be reused while the entry lives;
# bounded FIFO.
_GRID_CACHE: dict = {}
_GRID_CACHE_MAX = 8


def _median_split_order(cen: np.ndarray, st: int) -> np.ndarray:
    """BVH-style tile partition: recursively split the triangle set
    along the widest centroid axis, rounding the cut to a multiple of
    ``st`` so every leaf except possibly the last is a full tile.
    Contiguous st-chunks of the returned order are the leaves — tighter
    tile AABBs than Morton-order cuts (which slice a space-filling
    curve, leaving stragglers at curve folds)."""
    n = len(cen)
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if len(idx) <= st:
            out[pos:pos + len(idx)] = idx
            pos += len(idx)
            continue
        c = cen[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        ordax = idx[np.argsort(c[:, ax], kind="stable")]
        n_tiles = -(-len(idx) // st)
        cut = (n_tiles // 2) * st
        # LIFO: push right first so the left half lands first in `out`.
        stack.append(ordax[cut:])
        stack.append(ordax[:cut])
    return out


DEFAULT_TILE_ROWS = 128


def build_tri_grid(
    scene: TriangleScene,
    tile_rows: int = DEFAULT_TILE_ROWS,
    min_tris: int = 512,
    partition: str = "morton",
) -> Optional[TriGridScene]:
    """Build a :class:`TriGridScene`, or None when the mesh is too small
    to benefit (below ``min_tris`` the brute sweep is as cheap).
    Memoized on the scene object's identity (see _GRID_CACHE).
    ``partition``: "morton" (centroid space-filling-curve cuts) or
    "median" (recursive widest-axis median splits — tighter tile AABBs;
    see _median_split_order)."""
    key = (id(scene), tile_rows, min_tris, partition)
    cached = _GRID_CACHE.get(key)
    if cached is not None and cached.base is scene:
        return cached
    act = np.asarray(scene.active)
    sel = np.flatnonzero(act)
    if len(sel) < min_tris:
        return None
    v0 = np.asarray(scene.v0)[sel]
    e1 = np.asarray(scene.e1)[sel]
    e2 = np.asarray(scene.e2)[sel]

    # Triangle AABBs + centroid tile order.
    vs = np.stack([v0, v0 + e1, v0 + e2])                 # [3, F, 3]
    lo, hi = vs.min(axis=0), vs.max(axis=0)               # [F, 3]
    cen = 0.5 * (lo + hi)
    if partition == "median":
        order = _median_split_order(cen, tile_rows)
    elif partition == "morton":
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        ext = np.maximum(cmax - cmin, 1e-9)
        q = np.clip(((cen - cmin) / ext * 1023.0), 0,
                    1023).astype(np.uint32)
        order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]),
                           kind="stable")
    else:
        raise ValueError(f"unknown partition {partition!r} "
                         "(use morton|median)")

    st = tile_rows
    n_t = -(-len(sel) // st)
    attrs = np.zeros((n_t, st, TRI_ATTR_COLS), np.float32)
    boxes = np.empty((n_t, 6), np.float32)

    sc = {f: np.asarray(getattr(scene, f))[sel] for f in
          ("v0", "e1", "e2", "mat_id", "albedo", "fuzz", "ior")}
    for t in range(n_t):
        mem = order[t * st:(t + 1) * st]
        mem = mem[np.argsort(sel[mem], kind="stable")]  # earliest-idx ties
        m = len(mem)
        rows = np.zeros((m, TRI_ATTR_COLS), np.float32)
        rows[:, _T_V0X:_T_V0X + 3] = sc["v0"][mem]
        rows[:, _T_E1X:_T_E1X + 3] = sc["e1"][mem]
        rows[:, _T_E2X:_T_E2X + 3] = sc["e2"][mem]
        rows[:, _T_MAT] = sc["mat_id"][mem]
        rows[:, _T_ALR:_T_ALB + 1] = sc["albedo"][mem]
        rows[:, _T_FUZZ] = sc["fuzz"][mem]
        rows[:, _T_IOR] = sc["ior"][mem]
        rows[:, _T_IDX] = sel[mem]
        # Padding rows: e1 = e2 = 0 -> det = 0 -> rejected.
        attrs[t, :m] = rows
        boxes[t] = (lo[mem][:, 0].min(), hi[mem][:, 0].max(),
                    lo[mem][:, 1].min(), hi[mem][:, 1].max(),
                    lo[mem][:, 2].min(), hi[mem][:, 2].max())

    sbox = np.array([boxes[:, 0].min(), boxes[:, 1].max(),
                     boxes[:, 2].min(), boxes[:, 3].max(),
                     boxes[:, 4].min(), boxes[:, 5].max()], np.float32)

    grid = TriGridScene(
        base=scene,
        tile_attrs=jnp.asarray(attrs.reshape(n_t * st, TRI_ATTR_COLS)),
        tile_boxes=jnp.asarray(boxes),
        scene_box=jnp.asarray(sbox),
    )
    if len(_GRID_CACHE) >= _GRID_CACHE_MAX:
        _GRID_CACHE.pop(next(iter(_GRID_CACHE)))
    _GRID_CACHE[key] = grid
    return grid


def clip_segment_to_box(scene_box, origin, direction, t_cap=None,
                        min_t=0.001):
    """(lo_t, hi_t) [N] of each ray's [min_t, t_cap]-clipped chord
    through the [6] scene AABB (eps-guarded slab test; hi_t < lo_t =
    no touch).  THE touch classification — shared by the block mask
    below, the rebin sort keys (kernels/tri_rebin.capped_chord_keys),
    and the DDA pair expansion (kernels/tri_dda.dda_pairs): the rebin
    packing argument needs the key's no-touch set to agree with the
    schedule's empty set, so the slab logic must exist exactly once."""
    n = origin.shape[1]
    eps = np.float32(1e-12)
    lo_t = jnp.full((n,), np.float32(min_t))
    hi_t = jnp.full((n,), _BIG)
    if t_cap is not None:
        hi_t = jnp.minimum(hi_t, t_cap)
    for ax in range(3):
        o, d = origin[ax], direction[ax]
        d_safe = jnp.where(jnp.abs(d) < eps,
                           jnp.where(d < 0, -eps, eps), d)
        ta = (scene_box[2 * ax] - o) / d_safe
        tb = (scene_box[2 * ax + 1] - o) / d_safe
        lo_t = jnp.maximum(lo_t, jnp.minimum(ta, tb))
        hi_t = jnp.minimum(hi_t, jnp.maximum(ta, tb))
    return lo_t, hi_t


def tri_block_mask_rows(
    grid: TriGridScene,
    origin: jnp.ndarray,      # [3, Np] (padded to a ray_block multiple)
    direction: jnp.ndarray,   # [3, Np]
    t_cap: Optional[jnp.ndarray],  # [1, Np] occluding t or None
    min_t: float,
    ray_block: int,
) -> jnp.ndarray:
    """[Np/ray_block, T] int32 conservative block mask: 1 where the block
    must sweep the tile.  Per ray: slab-test against the scene AABB ->
    [t_in, t_out], clipped to [min_t, t_cap]; the segment's 3D box; per
    block min/max; per (block, tile) 3D overlap."""
    n = origin.shape[1]
    nb = n // ray_block
    lo_t, hi_t = clip_segment_to_box(
        grid.scene_box, origin, direction,
        t_cap=None if t_cap is None else t_cap[0], min_t=min_t)
    empty = lo_t > hi_t

    mins, maxs = [], []
    for ax in range(3):
        o, d = origin[ax], direction[ax]
        pa, pb = o + lo_t * d, o + hi_t * d
        mins.append(jnp.where(empty, _BIG, jnp.minimum(pa, pb))
                    .reshape(nb, ray_block).min(axis=1))
        maxs.append(jnp.where(empty, -_BIG, jnp.maximum(pa, pb))
                    .reshape(nb, ray_block).max(axis=1))

    bx = grid.tile_boxes                                  # [T, 6]
    overlap = ((mins[0][:, None] <= bx[None, :, 1])
               & (maxs[0][:, None] >= bx[None, :, 0])
               & (mins[1][:, None] <= bx[None, :, 3])
               & (maxs[1][:, None] >= bx[None, :, 2])
               & (mins[2][:, None] <= bx[None, :, 5])
               & (maxs[2][:, None] >= bx[None, :, 4]))
    return overlap.astype(jnp.int32)


def _sweep_tile_rows(tl, ox, oy, oz, dx, dy, dz, min_t):
    """Möller-Trumbore of [R]-rows rays against one [St, C] tile;
    returns the valid-hit t matrix [St, R] (F32_MAX where invalid — the
    caller reduces/argmins it)."""
    def col(c):
        return tl[:, c:c + 1]                             # [St, 1]

    e1x, e1y, e1z = col(_T_E1X), col(_T_E1X + 1), col(_T_E1X + 2)
    e2x, e2y, e2z = col(_T_E2X), col(_T_E2X + 1), col(_T_E2X + 2)
    px = dy * e2z - dz * e2y                              # pvec = d x e2
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = jnp.abs(det) >= _DET_EPS
    inv_det = 1.0 / jnp.where(ok_det, det, 1.0)
    tx = ox - col(_T_V0X)                                 # tvec = o - v0
    ty = oy - col(_T_V0X + 1)
    tz = oz - col(_T_V0X + 2)
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y                              # qvec = tvec x e1
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > min_t))
    return jnp.where(valid, t, F32_MAX)                   # [St, R]


def hit_triangles_grid_jnp(
    grid: TriGridScene,
    origin: jnp.ndarray,      # [3, N] rows
    direction: jnp.ndarray,   # [3, N]
    time: jnp.ndarray,        # [1, N] (unused; meshes static)
    min_t: float = MIN_HIT_T,
    ray_block: int = 512,
    t_cap: Optional[jnp.ndarray] = None,
):
    """Grid sweep: the brute Möller-Trumbore over every tile, with each
    tile's result kept only on lanes whose block mask admits the tile
    (must match the brute sweep up to the tie rule — the proof that the
    mask is conservative).  Returns (t [1, N], winner attribute rows
    g [TRI_ATTR_COLS, N], zeros on a miss)."""
    del time
    n = origin.shape[1]
    pad = (-n) % ray_block
    o, d = origin, direction
    if pad:
        o = jnp.pad(o, ((0, 0), (0, pad))).at[1, n:].set(-1e9)
        d = jnp.pad(d, ((0, 0), (0, pad))).at[2, n:].set(1.0)
        if t_cap is not None:
            t_cap = jnp.pad(t_cap, ((0, 0), (0, pad)))
    mask = tri_block_mask_rows(grid, o, d, t_cap, float(min_t), ray_block)
    lane_mask = jnp.repeat(mask, ray_block, axis=0).T     # [T, Np]
    ox, oy, oz = o[0:1], o[1:2], o[2:3]
    dx, dy, dz = d[0:1], d[1:2], d[2:3]

    st = grid.tile_rows
    best_t = jnp.full((1, o.shape[1]), F32_MAX)
    best_row = jnp.zeros((1, o.shape[1]), jnp.int32)
    for t_i in range(grid.n_tiles):
        tl = grid.tile_attrs[t_i * st:(t_i + 1) * st]
        t_all = _sweep_tile_rows(tl, ox, oy, oz, dx, dy, dz, min_t)
        tile_t = jnp.min(t_all, axis=0, keepdims=True)
        # First-occurrence argmin: within-tile ties keep the lowest row,
        # which build_tri_grid orders by original index.
        tile_row = (jnp.argmin(t_all, axis=0, keepdims=True)
                    .astype(jnp.int32) + t_i * st)
        better = (lane_mask[t_i:t_i + 1] > 0) & (tile_t < best_t)
        best_t = jnp.where(better, tile_t, best_t)
        best_row = jnp.where(better, tile_row, best_row)
    g = jnp.where(best_t < F32_MAX,
                  jnp.take(grid.tile_attrs.T, best_row[0], axis=1), 0.0)
    return best_t[:, :n], g[:, :n]


def hit_triangles_grid_rows_jnp(
    grid: TriGridScene,
    origin: jnp.ndarray,      # [3, N] rows
    direction: jnp.ndarray,   # [3, N]
    time: jnp.ndarray,        # [1, N] (unused; meshes static)
    min_t: float = MIN_HIT_T,
    ray_block: int = 512,
    t_cap: Optional[jnp.ndarray] = None,
):
    """Rows-layout hit function (ops/rows.py interface) over the grid
    sweep, with an optional occluding ``t_cap``."""
    from .ops.hit_tri import tri_record_rows_from_gather
    t_out, g = hit_triangles_grid_jnp(
        grid, origin, direction, time, min_t=min_t,
        ray_block=ray_block, t_cap=t_cap)
    return tri_record_rows_from_gather(origin, direction, t_out, g)
