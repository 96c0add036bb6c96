"""Difficulty-adaptive lane allocation for the persistent scheduler.

The persistent scheduler's wall-time tail is set by its hardest pixels:
with a uniform ``lanes_per_pixel`` K, every lane of a glass-and-ground
pixel carries spp/K samples of ~4x-mean path length, so those lanes run
~4x longer than the batch average and the render grinds its last ~100
steps on a nearly-dead batch.  The reference has the
same skew across its interleaved row blocks and simply eats it at join
time (win32-raytracer/RayTracer.cpp:973-1004).

Fix: allocate each pixel a lane count PROPORTIONAL TO ITS MEASURED
DIFFICULTY at a fixed total lane budget.  Difficulty comes free from a
prepass: render the first few samples per pixel with quota 1 — the final
``PathState.depth`` of a quota-1 lane IS its sample's path length (depth
freezes at termination; persistent._scatter_core) — so the prepass both
contributes its samples to the image and measures est[pixel].  Lanes of
one pixel stay contiguous, so est aggregation is a reshape-sum, not a
gather.

The allocator below builds the phase-2 lane arrays (pixel, s_base,
s_quota) ON DEVICE with scatter+cumsum only — no host round trip.
Opt-in (cfg.adaptive_alloc); its speed on a GPU is not measured.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.jit, static_argnames=("n_lanes", "spp_done", "spp", "kpp_max"))
def alloc_lanes(est: jnp.ndarray, *, n_lanes: int, spp_done: int,
                spp: int, kpp_max: int = 32,
                pixel_ids: jnp.ndarray = None,
                q_rest: jnp.ndarray = None):
    """Build phase-2 lane arrays from per-pixel difficulty estimates.

    est      [P] f32/i32, nonnegative (total prepass path steps per
             pixel; any monotone difficulty proxy works).
    n_lanes  L, the fixed lane budget (L >= P: every pixel gets >= 1).
    spp_done samples already rendered per pixel (the prepass).
    spp      total samples per pixel; phase 2 renders spp - spp_done.
    kpp_max  soft cap on lanes per pixel (hard cap: spp - spp_done, a
             lane needs >= 1 sample; rounding may exceed the soft cap by
             a few lanes — harmless, it is a heuristic bound).
    pixel_ids optional [P] i32: actual pixel ids to emit (default
             arange(P)) — lets a mesh shard allocate over its own
             interleaved row-block pixel set.
    q_rest   optional [P] i32: per-pixel remaining sample count
             (default spp - spp_done) — 0 marks a pixel whose lanes
             never run (a shard's wrap-padding duplicates).

    Returns (pixel, s_base, s_quota), each [1, L] i32, slot order
    preserved (lanes of one pixel contiguous — compaction's sorted-tail
    flush and chunk slicing rely on this when pixel_ids is ascending).
    Invariants (exact, by construction): every pixel owns >= 1 lane;
    lane counts sum to L; each pixel's lanes partition
    [spp_done, spp_done + q_rest) disjointly and completely.
    """
    P = est.shape[0]
    spp_rest = spp - spp_done
    assert n_lanes >= P, (n_lanes, P)
    kmax = min(kpp_max, spp_rest)
    pool = n_lanes - P                 # lanes beyond the 1-per-pixel floor

    # Proportional share of the pool, soft-capped so no pixel asks for
    # more than ~kmax lanes (one renormalization; the cap is soft).
    # Guard the degenerate all-zero estimate (e.g. a shard of pure pads).
    w = est.astype(jnp.float32)
    w = w / jnp.maximum(jnp.sum(w), 1e-30)
    w = jnp.minimum(w, kmax / max(n_lanes, 1))
    w = w / jnp.maximum(jnp.sum(w), 1e-30)
    # Boundary rounding keeps the total EXACT under f32 cumsum error:
    # bnd is monotone (cumsum of nonnegatives), clamped to pool, and the
    # last entry is forced — so diffs are >= 0 and sum to pool.
    bnd = jnp.round(jnp.cumsum(w) * pool).astype(jnp.int32)
    bnd = jnp.minimum(bnd, pool).at[-1].set(pool)
    kpp_p = jnp.diff(bnd, prepend=0) + 1          # [P] lanes per pixel
    starts = jnp.cumsum(kpp_p) - kpp_p            # [P] exclusive starts

    # Broadcast per-pixel values to lanes without gathers: scatter the
    # value DIFFS at each pixel's first lane, then prefix-sum.  starts
    # are strictly increasing (kpp_p >= 1) so indices are unique.
    def to_lanes(vals_p):
        d = jnp.diff(vals_p, prepend=0)
        z = jnp.zeros((n_lanes,), jnp.int32).at[starts].add(d)
        return jnp.cumsum(z)

    if pixel_ids is None:
        pixel_ids = jnp.arange(P, dtype=jnp.int32)
    pixel = to_lanes(pixel_ids.astype(jnp.int32))
    kpp_l = to_lanes(kpp_p)
    start_l = to_lanes(starts)
    r = jnp.arange(n_lanes, dtype=jnp.int32) - start_l  # replica rank
    # Balanced partition of the pixel's remaining samples among its
    # kpp_l lanes: the first (rest % kpp_l) lanes carry one extra.
    if q_rest is None:
        rest_l = spp_rest
    else:
        rest_l = to_lanes(q_rest.astype(jnp.int32))
    q_div = rest_l // kpp_l
    q_mod = rest_l % kpp_l
    s_quota = q_div + (r < q_mod).astype(jnp.int32)
    s_base = spp_done + r * q_div + jnp.minimum(r, q_mod)
    return pixel[None], s_base[None], s_quota[None]
