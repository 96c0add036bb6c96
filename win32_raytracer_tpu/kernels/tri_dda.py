"""Per-tile gather via DDA macro-cell expansion ("bin rays to tiles").

The two-phase re-bin (tri_rebin.py) tightens per-block tile unions, but
every lane still pays its whole block's schedule; on real bounce
snapshots that WITHIN-block waste leaves most of the per-ray ideal on
the table.  This module takes the next step — still plain XLA:

1. march each lane's occlusion-capped chord through a G^3 macro-cell
   grid over the scene box (fixed-K DDA, all static shapes)
2. EXPAND lanes into (cell, chord-interval) pairs — K static slots per
   lane; lanes whose chord visits more than K cells fall back to one
   full-segment pair (conservative, never wrong)
3. sort the K*N pair working set by cell id (dead pairs last) and run
   the EXISTING grid sweep on it: each ray block now covers ~one
   cell, so its conservative union is that cell's tiles, not a
   degenerate chord-union
4. shift each pair's origin to its interval start so the sweep's
   [min_t, cap] window IS the interval (t corrected back after), then
   merge the K slots per lane by nearest-t and unsort by lane index

cfg.tri_dda_k picks K.  The sweep computes every tile and discards the
masked ones, so on the GPU this is a structure to build a culling
triangle kernel on, not a speed-up; its speed is not measured.

Exactness: every pair's mask window covers its chord interval, the
intervals tile the capped chord, and the winning hit lies in one of
them (or in the full-segment fallback), so the merged record equals the
direct pass wherever the hit survives t_cap — the same effective
contract as tri_rebin.py, tested at render level as bitwise equality.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rows import HitRecordRows

_DEAD_KEY = np.int32(1 << 20)
_PARK_O = (0.0, -1e9, 0.0)  # kernels' parked-ray convention
_PARK_D = (0.0, 0.0, 1.0)


def dda_pairs(scene_box, o, d, t_cap, g_cells=8, k_max=4, min_t=0.001):
    """Expand lanes into K static (cell, interval) pair slots.

    Returns (key [K*N] int32, o_p [3, K*N], d_p [3, K*N],
    cap_p [1, K*N], t_off [K*N], lane [K*N] int32).  Slot 0 keeps the
    original origin (its window [min_t, hi_0] is exact because the
    pre-box segment crosses no tile); slots k>=1 shift the origin to
    interval start minus min_t so the kernel window is the interval.
    Overflow lanes (chord longer than K cells) collapse to one
    full-segment pair in slot 0."""
    n = o.shape[1]
    f32 = jnp.float32
    eps = np.float32(1e-12)
    lo3 = [scene_box[0], scene_box[2], scene_box[4]]
    csz = [jnp.maximum(scene_box[2 * ax + 1] - scene_box[2 * ax],
                       np.float32(1e-6)) / g_cells for ax in range(3)]
    dn = [jnp.where(jnp.abs(d[ax]) < eps,
                    jnp.where(d[ax] < 0, -eps, eps), d[ax])
          for ax in range(3)]  # kept for the DDA boundary stepping
    from ..tri_accel import clip_segment_to_box
    lo_t, hi_c = clip_segment_to_box(scene_box, o, d, t_cap=t_cap,
                                     min_t=min_t)
    touch = hi_c >= lo_t

    keys, los, his = [], [], []
    t_cur = lo_t
    tiny = np.float32(1e-5)
    for _ in range(k_max):
        live = touch & (t_cur < hi_c)
        t_safe = jnp.where(live, t_cur, 0.0)
        # cell of the point just inside the interval start
        cid = jnp.zeros_like(o[0], jnp.int32)
        cs = []
        for ax in range(3):
            p = o[ax] + (t_safe + tiny) * d[ax]
            c = jnp.clip(((p - lo3[ax]) / csz[ax]).astype(jnp.int32),
                         0, g_cells - 1)
            cs.append(c)
            cid = cid + c * (g_cells ** ax)
        # next boundary crossing after t_cur
        t_next = jnp.full_like(t_cur, np.float32(3.4e38))
        for ax in range(3):
            step_to = (lo3[ax]
                       + (cs[ax] + (dn[ax] > 0).astype(f32)) * csz[ax])
            t_ax = (step_to - o[ax]) / dn[ax]
            t_next = jnp.minimum(t_next,
                                 jnp.where(t_ax > t_cur + tiny, t_ax,
                                           np.float32(3.4e38)))
        t_next = jnp.maximum(t_next, t_cur + tiny)  # guaranteed progress
        keys.append(jnp.where(live, cid, _DEAD_KEY))
        los.append(jnp.where(live, t_cur, 0.0))
        his.append(jnp.where(live, jnp.minimum(t_next, hi_c), 0.0))
        t_cur = t_next
    overflow = touch & (t_cur < hi_c)

    lane = jnp.arange(n, dtype=jnp.int32)
    key_rows, op_rows, dp_rows, cap_rows, off_rows, lane_rows = (
        [], [], [], [], [], [])
    for k in range(k_max):
        live = keys[k] != _DEAD_KEY
        if k == 0:
            # slot 0: original origin; full segment for overflow lanes
            hi0 = jnp.where(overflow, hi_c, his[0])
            o_p = [jnp.where(live, o[ax], np.float32(_PARK_O[ax]))
                   for ax in range(3)]
            cap = jnp.where(live, hi0, 0.0)
            off = jnp.zeros_like(hi0)
        else:
            live = live & ~overflow
            off = los[k] - np.float32(min_t)
            o_p = [jnp.where(live, o[ax] + off * d[ax],
                             np.float32(_PARK_O[ax])) for ax in range(3)]
            cap = jnp.where(live, his[k] - off, 0.0)
            off = jnp.where(live, off, 0.0)
        d_p = [jnp.where(live, d[ax], np.float32(_PARK_D[ax]))
               for ax in range(3)]
        key_rows.append(jnp.where(live, keys[k], _DEAD_KEY))
        op_rows.append(jnp.stack(o_p))
        dp_rows.append(jnp.stack(d_p))
        cap_rows.append(cap)
        off_rows.append(off)
        lane_rows.append(lane)
    key = jnp.concatenate(key_rows)
    o_p = jnp.concatenate(op_rows, axis=1)
    d_p = jnp.concatenate(dp_rows, axis=1)
    cap_p = jnp.concatenate(cap_rows)[None]
    t_off = jnp.concatenate(off_rows)
    lane_i = jnp.concatenate(lane_rows)
    return key, o_p, d_p, cap_p, t_off, lane_i


def dda_tri_pass(tri_fn, grid, o, d, time, t_cap, g_cells=8, k_max=4,
                 min_t=0.001):
    """Run ``tri_fn`` on the cell-sorted pair expansion; return the
    HitRecordRows in the original lane order (nearest hit over each
    lane's pairs, t corrected by each pair's interval offset)."""
    n = o.shape[1]
    key, o_p, d_p, cap_p, t_off, lane_i = dda_pairs(
        grid.scene_box, o, d, t_cap[0], g_cells=g_cells, k_max=k_max,
        min_t=min_t)
    srt = jax.lax.sort(
        (key, o_p[0], o_p[1], o_p[2], d_p[0], d_p[1], d_p[2],
         cap_p[0], t_off, lane_i),
        dimension=0, num_keys=1, is_stable=True)
    _, ox, oy, oz, dx, dy, dz, cap_s, off_s, lane_s = srt
    nk = key.shape[0]
    tm = jnp.zeros((1, nk), jnp.float32)
    rec = tri_fn(grid, jnp.stack([ox, oy, oz]), jnp.stack([dx, dy, dz]),
                 tm, min_t=min_t, t_cap=cap_s[None])
    # true-t correction, and discard beyond-window hits (they belong to
    # another pair's window; keeping them would double-count with the
    # wrong offset being harmless — min merge — but cap them anyway so
    # the no-hit fields stay canonical)
    t_true = rec.t[0] + off_s
    hit = rec.hit[0] & (rec.t[0] <= cap_s)
    # unsort by lane: every lane owns exactly k_max pair slots
    flat = [lane_s, hit.astype(jnp.int32), t_true]
    layout = []
    for f, arr in zip(rec._fields, rec):
        if f in ("hit", "t"):
            continue
        layout.append((f, arr.shape[0], arr.dtype))
        for r in range(arr.shape[0]):
            flat.append(arr[r])
    out = jax.lax.sort(tuple(flat), dimension=0, num_keys=1,
                       is_stable=True)
    hit_l = out[1].reshape(n, k_max).T.astype(jnp.bool_)   # [K, N]
    t_l = out[2].reshape(n, k_max).T
    rest = list(out[3:])
    cols = {}
    for f, rows_n, dt in layout:
        rows = [rest.pop(0).reshape(n, k_max).T for _ in range(rows_n)]
        cols[f] = jnp.stack(rows)                           # [rows, K, N]
    # nearest-hit merge over the K slots
    t_cand = jnp.where(hit_l, t_l, np.float32(3.4e38))
    best = jnp.argmin(t_cand, axis=0)                       # [N]
    onehot = jax.nn.one_hot(best, k_max, axis=0,
                            dtype=jnp.float32)              # [K, N]
    any_hit = hit_l.any(axis=0)
    t_best = jnp.min(t_cand, axis=0)
    f32_max = np.float32(3.4028235e38)
    merged = {"hit": any_hit[None],
              "t": jnp.where(any_hit, t_best, f32_max)[None]}
    for f, rows_n, dt in layout:
        # Contract in the field's OWN dtype: integer fields (idx,
        # mat_id) routed through a float32 one-hot would silently round
        # above 2^24 (a ~16.8M-triangle mesh corrupts winning indices);
        # an int32 einsum over K slots is exact and stays a cheap VPU op.
        merged[f] = jnp.einsum("kn,rkn->rn", onehot.astype(dt), cols[f])
    return HitRecordRows(**merged)
