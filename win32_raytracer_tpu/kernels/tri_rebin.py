"""Two-phase triangle pass: occlusion-capped working-set re-binning.

The triangle grid (tri_accel.py) culls tiles per RAY BLOCK: a tile is
admitted when the union of the block's clipped t-segments reaches its
AABB.  The driver-level lane sort (persistent._bin_sort)
runs BEFORE the hit phase, so the sphere pass's occlusion — which caps
most segments to tiny lengths or kills them outright — is invisible to
the sort key; short-capped lanes mix with genuine mesh-goers and every
block's conservative union degenerates.

This module restructures the composite hit phase with two extra
multi-operand lax.sorts around the existing triangle grid sweep:

1. sphere pass over ALL lanes (unchanged) -> rec_s
2. key every lane by (origin cell, occlusion-CAPPED chord-exit cell,
   direction octant); lanes whose capped segment misses the grid's
   AABB get key MAX — they pack into trailing blocks whose union
   schedules ~zero tiles
3. lax.sort the triangle WORKING SET only (o, d, t_cap, lane index —
   8 rows, not the 19-row path state)
4. tri grid sweep on the sorted set (tight per-block unions)
5. lax.sort the hit record back by lane index (the inverse
   permutation), combine with rec_s

Because the PATH STATE is never permuted, per-lane RNG streams are
untouched: renders match the rebin-off path exactly (up to the grid's
cross-tile tie rule), unlike driver-level binning whose lane
permutation changes sample streams statistically.

Reference parity: this replaces the reference's per-ray recursive
traversal economics (win32-raytracer/RayTracer.cpp:433-551 tests every
sphere per ray; it has no mesh path at all) with a sorted wavefront
schedule — a capability the reference never had.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rows import HitRecordRows

_NO_TOUCH = np.int32(1 << 20)


def capped_chord_keys(scene_box, o, d, t_cap, min_t=0.001):
    """int32 sort keys: (origin cell 4^3, capped-exit cell 4^3, octant),
    _NO_TOUCH for lanes whose [min_t, t_cap]-clipped segment misses the
    grid AABB.  ``scene_box`` = TriGridScene.scene_box, the [6] array
    (lo_x, hi_x, lo_y, hi_y, lo_z, hi_z) — traced, so the hit fn stays
    scene-generic under jit."""
    from ..tri_accel import clip_segment_to_box
    lo3 = [scene_box[0], scene_box[2], scene_box[4]]
    inv_ext = [1.0 / jnp.maximum(scene_box[2 * ax + 1] - scene_box[2 * ax],
                                 np.float32(1e-6)) for ax in range(3)]
    lo_t, hi_t = clip_segment_to_box(scene_box, o, d, t_cap=t_cap,
                                     min_t=min_t)
    no_touch = hi_t < lo_t

    def cells4(p):
        cs = []
        for ax in range(3):
            c = ((p[ax] - lo3[ax]) * (inv_ext[ax] * 4)).astype(jnp.int32)
            cs.append(jnp.clip(c, 0, 3))
        return cs

    def spread3(v):
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)

    def morton(cs):
        return (spread3(cs[0]) | (spread3(cs[1]) << 1)
                | (spread3(cs[2]) << 2))

    hi_c = jnp.maximum(hi_t, 0.0)
    lo_c = jnp.maximum(lo_t, 0.0)
    # Box-ENTRY point, not raw origin: lanes starting far outside the
    # grid box land in the cell where their chord actually begins.
    entry_p = [o[ax] + lo_c * d[ax] for ax in range(3)]
    exit_p = [o[ax] + hi_c * d[ax] for ax in range(3)]
    octant = ((d[0] < 0).astype(jnp.int32)
              | ((d[1] < 0).astype(jnp.int32) << 1)
              | ((d[2] < 0).astype(jnp.int32) << 2))
    key = ((morton(cells4(entry_p)) << 9) | (morton(cells4(exit_p)) << 3)
           | octant)
    return jnp.where(no_touch, _NO_TOUCH, key)


def sorted_tri_pass(tri_fn, grid, o, d, time, t_cap, min_t=0.001):
    """Run ``tri_fn(grid, o, d, time, min_t=, t_cap=)`` on the working
    set sorted by capped chord key; return the HitRecordRows in the
    ORIGINAL lane order.  ``t_cap`` [1, N] (sphere-pass nearest t or
    +inf).  ``tri_fn`` is any rows-record tri grid function."""
    n = o.shape[1]
    keys = capped_chord_keys(grid.scene_box, o, d, t_cap[0], min_t=min_t)
    idx = jnp.arange(n, dtype=jnp.int32)
    srt = jax.lax.sort(
        (keys, o[0], o[1], o[2], d[0], d[1], d[2], t_cap[0], time[0], idx),
        dimension=0, num_keys=1, is_stable=True)
    _, ox, oy, oz, dx, dy, dz, cap_s, tm_s, sidx = srt
    rec_t = tri_fn(grid, jnp.stack([ox, oy, oz]),
                   jnp.stack([dx, dy, dz]), tm_s[None],
                   min_t=min_t, t_cap=cap_s[None])
    # Inverse permutation via a second sort keyed by the lane index.
    # ``point`` is NOT carried through the sort: it is o + t*d, so after
    # unsorting t it reconstructs bitwise-identically from the ORIGINAL
    # o/d — three FMAs instead of 3 of 16 operand rows of sort
    # bandwidth on every triangle pass.
    flat = [sidx]
    layout = []  # (field, rows, dtype) to rebuild
    for f, arr in zip(rec_t._fields, rec_t):
        if f == "point":
            continue
        layout.append((f, arr.shape[0], arr.dtype))
        for r in range(arr.shape[0]):
            # sort operands must share the key's shape; cast bools to
            # int32 and back (lax.sort supports mixed dtypes, but bool
            # rows round-trip exactly through int32 anyway)
            row = arr[r]
            flat.append(row.astype(jnp.int32) if arr.dtype == jnp.bool_
                        else row)
    out = jax.lax.sort(tuple(flat), dimension=0, num_keys=1,
                       is_stable=True)
    rest = list(out[1:])
    cols = {}
    for f, rows_n, dt in layout:
        rows = rest[:rows_n]
        rest = rest[rows_n:]
        stacked = jnp.stack(rows) if rows_n > 1 else rows[0][None]
        cols[f] = stacked.astype(dt) if dt == jnp.bool_ else stacked
    # Same miss convention as the hit epilogue (t_safe = 0 -> origin).
    t_safe = jnp.where(cols["hit"], cols["t"], 0.0)
    cols["point"] = o + t_safe * d
    return HitRecordRows(**cols)
