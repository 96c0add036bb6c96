"""Persistent wavefront scheduler with batch compaction (lane-major).

The fixed-depth wavefront (render.py) retires lanes as their paths end, so
by depth 5+ most of the batch is dead weight.  This scheduler pins K
replica lanes per *pixel* (each owning spp/K samples) and runs samples
sequentially per lane, respawning the next camera sample the moment a path
terminates (sky / metal absorb / depth exhaustion) — the SPMD answer to the
reference's interleaved-block load balancing
(win32-raytracer/RayTracer.cpp:973-978).

Pixel difficulty varies wildly (a sky pixel finishes 100 samples in ~100
steps; a glass-and-ground pixel needs ~8x that), which leaves a long tail
of mostly-dead batches.  So the driver periodically *compacts*: it flushes
every lane's completed-sample radiance into a device accumulator image,
drops finished lanes, and continues with the survivors in a next-power-of-2
batch — work tracks the live-lane integral instead of worst-pixel x batch.

State is **lane-major** ([3, N] vectors / [1, N] scalars, ops/rows.py), so
every field a step reads is a contiguous row.

Semantics are identical to the reference recursion: hit tests happen at
recursion levels 0..max_depth (RayTracer.cpp:399-402); a miss at any level
adds throughput-weighted sky (RayTracer.cpp:690-701); a path still alive
after its level-max_depth scatter contributes black.

Small pipelined step programs (hit / scatter+respawn) driven from Python,
one device sync per ``check_period`` steps; below the compaction floor,
multi-bounce and whole-chunk while-loop programs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .config import RenderConfig
from .core.rng import hash_uniform01
from .ops.rows import (
    HitRecordRows, camera_rays_rows, scatter_rows, sky_color_rows,
)
from .scene.camera import Camera, default_camera
from .scene.spheres import SphereScene


class PathState(NamedTuple):
    origin: jnp.ndarray        # [3, N]
    direction: jnp.ndarray     # [3, N]
    time: jnp.ndarray          # [1, N]
    throughput: jnp.ndarray    # [3, N]
    radiance_sum: jnp.ndarray  # [3, N] — completed samples since last flush
    depth: jnp.ndarray         # [1, N] i32 — recursion level of the next hit
    sample: jnp.ndarray        # [1, N] i32 — lane-local sample index (-1 = none)
    pixel: jnp.ndarray         # [1, N] i32 — pixel-lane id: (y*W + x)*K + replica
    path_alive: jnp.ndarray    # [1, N] bool
    s_base: jnp.ndarray        # [1, N] i32 — lane's first global sample index
    s_quota: jnp.ndarray       # [1, N] i32 — samples owned by this lane


def _hit_core(scene: SphereScene, st: PathState, *, cfg: RenderConfig,
              hit_fn):
    rec: HitRecordRows = hit_fn(scene, st.origin, st.direction, st.time,
                                min_t=cfg.min_hit_t)
    miss = st.path_alive & ~rec.hit
    rad = st.radiance_sum + jnp.where(
        miss, st.throughput * sky_color_rows(st.direction), 0.0)
    return rec, st._replace(radiance_sum=rad,
                            path_alive=st.path_alive & rec.hit)


# ---------------------------------------------------------------------------
# Traced render dimensions.
#
# width/height/spp/lanes_per_pixel/max_depth/RR/stratify used to be STATIC
# jit arguments, so every (image size, spp, knob) combination compiled its
# own copy of every step program, even for lane counts other configs had
# already compiled.  They now ride as ONE traced i32[8]
# operand ("dims"), so step programs key only on (lane count, normalized
# config, hit_fn, n_frames) and every image size shares them.
#
# Layout (make_dims):
#   0 width   1 height   2 kpp          3 kpp_shift (log2 kpp, -1 = not pow2)
#   4 kx      5 ky       6 max_depth    7 rr_start (> max_depth = RR off)
#
# Stratification is ALWAYS traced with grid (kx, ky) — (1, 1) reproduces
# the unstratified jitter bit-exactly ((0 + u)/1).  Russian roulette is
# ALWAYS traced with threshold rr_start — a start depth beyond max_depth
# never fires and leaves throughput/alive untouched bit-exactly (the 5th
# draw row was always generated).  Folding both into dims means flipping
# cfg.stratify / cfg.russian_roulette / cfg.max_depth recompiles NOTHING.
# ---------------------------------------------------------------------------

def make_dims(cfg: RenderConfig, width: int, height: int, spp: int,
              lanes_per_pixel: int = 1) -> jnp.ndarray:
    """The traced dims operand every step program consumes (see layout
    above).  Derives the stratify grid and RR threshold from ``cfg`` so
    callers pass the ORIGINAL config here and the normalized one
    (``step_cfg``) as the static argument."""
    kpp = lanes_per_pixel
    kpp_shift = kpp.bit_length() - 1 if kpp & (kpp - 1) == 0 else -1
    if cfg.stratify and spp > 1:
        kx, ky = _stratify_grid(spp)
    else:
        kx, ky = 1, 1
    rr_start = (cfg.rr_start_depth if cfg.russian_roulette
                else cfg.max_depth + 2)
    return jnp.asarray([width, height, kpp, kpp_shift, kx, ky,
                        cfg.max_depth, rr_start], jnp.int32)


# Config fields that still shape step-program CONTENT (the reference's
# numerical quirks + numerics).  Everything else — image dims, sampling
# counts, scheduler/compaction/acceleration knobs — either rides the
# traced dims operand or is a host-side driver decision, so ``step_cfg``
# resets it to the dataclass default: flipping a driver knob (check
# cadence, one_shot mode, compaction quantum, tri_* defaults...) no
# longer invalidates a single compiled step program.  (Tri knobs reach
# the programs through the lru-cached hit_fn IDENTITY instead.)
_STEP_FIELDS = ("refract_discriminant_bias", "schlick_uses_ni_over_nt",
                "reflect_thres", "epsilon", "min_hit_t", "deterministic")


@functools.lru_cache(maxsize=None)
def _step_cfg_cached(vals: tuple) -> RenderConfig:
    return RenderConfig(**dict(zip(_STEP_FIELDS, vals)))


def step_cfg(cfg: RenderConfig) -> RenderConfig:
    """Normalize ``cfg`` to the fields that affect step-program content
    (cached so the same normalized config is the same OBJECT — jit
    static-arg hashing stays cheap and stable)."""
    return _step_cfg_cached(tuple(getattr(cfg, f) for f in _STEP_FIELDS))


def _exact_divmod_any(x: jnp.ndarray, d) -> tuple:
    """Floor divmod of non-negative i32 ``x`` by a positive TRACED i32
    scalar ``d``, via f32 reciprocal-multiply — exact for x < 2^29 and
    any d >= 1.

    Stage 1's quotient error is <= x*2^-22/d + 1, so the integer residual
    r1 = x - q*d satisfies |r1| <= x*2^-22 + d + 2 (< d + 130 at
    x < 2^29); stage 2's q2 = trunc(f32(r1) * inv) then lands within 1 of
    r1/d even where f32(r1) rounds, leaving |r| within 2d of the true
    remainder — which the +/-2 correction sweeps close for ANY d >= 1 up
    to the 2^29 input bound (verified exhaustively-at-random across d in
    [1, 2^29) by test_exact_divmod_any_exactness; in-tree divisors are
    all < 2^17)."""
    d = jnp.asarray(d, jnp.int32)   # accept python ints (constant-folds)
    d_f = d.astype(jnp.float32)
    inv = 1.0 / d_f
    q = (x.astype(jnp.float32) * inv).astype(jnp.int32)
    r = x - q * d
    q2 = (r.astype(jnp.float32) * inv).astype(jnp.int32)
    q = q + q2
    r = r - q2 * d
    for _ in range(2):
        neg = (r < 0).astype(jnp.int32)
        q = q - neg
        r = r + neg * d
    for _ in range(2):
        ge = (r >= d).astype(jnp.int32)
        q = q + ge
        r = r - ge * d
    return q, r


def _scatter_core(scene: SphereScene, st: PathState, rec,
                  salt: jnp.ndarray, step_i: jnp.ndarray,
                  dims: jnp.ndarray, *, cfg: RenderConfig,
                  lean: bool = False) -> PathState:
    n = st.origin.shape[1]
    draws = hash_uniform01((5, n), salt, step_i, 0x5CA77E12)
    sc = scatter_rows(st.direction, rec, draws, cfg)

    live = st.path_alive  # already restricted to hits by p_hit_step
    thr = jnp.where(live, st.throughput * sc.attenuation, st.throughput)
    o = jnp.where(live, sc.origin, st.origin)
    d = jnp.where(live, sc.direction, st.direction)
    depth = jnp.where(live, st.depth + 1, st.depth)
    alive = live & sc.alive & (depth <= dims[6])

    # Russian roulette, traced via rr_start: rr_start > max_depth (the
    # RR-off encoding) leaves thr/alive bit-identical — and the block is
    # compiled OUT entirely when the static ``lean`` flag says RR is off
    # for this render.
    if not lean:
        p = jnp.clip(jnp.max(thr, axis=0, keepdims=True), 0.05, 1.0)
        rr_on = alive & (depth >= dims[7])
        survive = draws[4:5] < p
        thr = jnp.where(rr_on, thr / p, thr)
        alive = alive & jnp.where(rr_on, survive, True)

    return st._replace(origin=o, direction=d, throughput=thr, depth=depth,
                       path_alive=alive)


@functools.lru_cache(maxsize=None)
def _stratify_grid(spp: int) -> tuple:
    """(kx, ky) with kx*ky == spp and kx the largest divisor <= sqrt(spp)."""
    kx = 1
    for cand in range(1, int(np.sqrt(spp)) + 1):
        if spp % cand == 0:
            kx = cand
    return kx, spp // kx


def _respawn_core(cam: Camera, st: PathState, salt: jnp.ndarray,
                  step_i: jnp.ndarray, dims: jnp.ndarray, *,
                  cfg: RenderConfig, n_frames: int = 1,
                  lean: bool = False) -> PathState:
    """Start the next camera sample on every lane whose path just ended.

    ``dims`` (make_dims) carries width/height/kpp/stratify grid as traced
    scalars — one compiled program per lane count serves every image size.

    With lanes-per-pixel K > 1 (dims[2]), each pixel's spp samples are
    split over K replica lanes (quota spp//K each) — K-fold fewer
    sequential steps for hard pixels at identical total work.

    With ``n_frames`` F > 1, the batch renders F frames of an animation at
    once (pixel-lane ids span a virtual F*height image; lane frame =
    row // height) and ``cam`` is a frame-stacked Camera (every field with
    a leading [F] axis).  Batching frames amortizes the scheduler tail,
    the alive-check syncs, and the dispatch floor over F frames — the
    wavefront answer to "interactive-rate small renders" (the reference's
    Tick loop, Game.cpp:140-270, draws one frame at a time because a CPU
    has no batch dimension to waste)."""
    n = st.pixel.shape[1]
    width, height = dims[0], dims[1]
    kpp, kx, ky = dims[2], dims[4], dims[5]
    # Pixel-lane id -> (x, y[, frame]) with ONE wide reciprocal divmod
    # (by width*kpp) plus narrow ones on the small remainders, instead
    # of chained i32 ``//``/``%`` by traced scalars (each a full 32-bit
    # XLA expansion — see _exact_divmod_any).  pix = y_virt*(W*kpp)
    # + rem with rem < W*kpp, so x = rem // kpp exactly.
    wk = width * kpp
    y_virt, rem = _exact_divmod_any(st.pixel, wk)
    x, _ = _exact_divmod_any(rem, kpp)
    if n_frames > 1:
        fid, y = _exact_divmod_any(y_virt, height)
        # Per-lane camera: unrolled select over the (static, small) frame
        # count — [F]-leading camera fields become [.., N] row operands
        # that camera_rays_rows broadcasts like scalars.
        def sel(field):
            field = jnp.asarray(field, jnp.float32)
            if field.ndim == 2:           # [F, 3] vector -> [3, N]
                v = field[0][:, None]
                for f in range(1, n_frames):
                    v = jnp.where(fid == f, field[f][:, None], v)
            else:                         # [F] scalar -> [1, N]
                v = jnp.broadcast_to(field[0], fid.shape)
                for f in range(1, n_frames):
                    v = jnp.where(fid == f, field[f], v)
            return v
        cam = Camera(*(sel(getattr(cam, f)) for f in cam._fields))
    else:
        y = y_virt

    start = ~st.path_alive & (st.sample < st.s_quota - 1)
    new_sample = jnp.where(start, st.sample + 1, st.sample)

    draws = hash_uniform01((5, n), salt, step_i, 0x2E59A301)
    u_j, v_j = draws[0:1], draws[1:2]
    # Stratified jitter, traced via (kx, ky): any spp factors as a kx*ky
    # grid (make_dims; kx = largest divisor <= sqrt(spp)); square spp
    # reproduces the classic k x k layout, prime spp degrades to 1 x spp
    # (v-only) strata.  Stratify-off rides as (1, 1), which reproduces
    # the plain jitter bit-exactly ((0 + u)/1) — and the block is
    # compiled OUT when the static ``lean`` flag says this render cannot
    # stratify (two divmods saved per lane-step).
    if not lean:
        gs = st.s_base + new_sample  # global sample index
        gq, sx_i = _exact_divmod_any(gs, kx)
        _, sy_i = _exact_divmod_any(gq, ky)
        u_j = (sx_i.astype(jnp.float32) + u_j) / kx.astype(jnp.float32)
        v_j = (sy_i.astype(jnp.float32) + v_j) / ky.astype(jnp.float32)
    # Pixel mapping as RayTracer.cpp:941-943 (u=(x+r0)/W, v=(H-y+r1)/H).
    u = (x.astype(jnp.float32) + u_j) / width.astype(jnp.float32)
    v = (((height - y).astype(jnp.float32) + v_j)
         / height.astype(jnp.float32))
    o, d, tm = camera_rays_rows(cam, u, v, draws[2:5])

    return st._replace(
        origin=jnp.where(start, o, st.origin),
        direction=jnp.where(start, d, st.direction),
        time=jnp.where(start, tm, st.time),
        throughput=jnp.where(start, 1.0, st.throughput),
        depth=jnp.where(start, 0, st.depth),
        sample=new_sample,
        path_alive=st.path_alive | start,
    )


# Jitted single-phase steps (kept for tests and the shard_map layer).
p_hit_step = functools.partial(jax.jit, static_argnames=("cfg", "hit_fn"))(_hit_core)
p_scatter_step = functools.partial(
    jax.jit, static_argnames=("cfg", "lean"))(_scatter_core)
p_respawn_step = functools.partial(
    jax.jit, static_argnames=("cfg", "n_frames", "lean"))(_respawn_core)


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_frames", "lean"))
def p_scatter_respawn_step(scene: SphereScene, cam: Camera, st: PathState,
                           rec, salt: jnp.ndarray,
                           step_i: jnp.ndarray, dims: jnp.ndarray, *,
                           cfg: RenderConfig,
                           n_frames: int = 1,
                           lean: bool = False) -> PathState:
    """Scatter + respawn in ONE dispatch (pure row arithmetic that XLA
    fuses).  The above-floor bounce is this plus the hit program."""
    st = _scatter_core(scene, st, rec, salt, step_i, dims, cfg=cfg,
                       lean=lean)
    return _respawn_core(cam, st, salt, step_i, dims, cfg=cfg,
                         n_frames=n_frames, lean=lean)


@functools.partial(
    jax.jit, static_argnames=("cfg", "hit_fn", "n_frames", "lean"))
def p_bounce_step(scene: SphereScene, cam: Camera, st: PathState,
                  salt: jnp.ndarray, step_i: jnp.ndarray,
                  dims: jnp.ndarray, *, cfg: RenderConfig,
                  hit_fn, n_frames: int = 1,
                  lean: bool = False) -> PathState:
    """Fused hit + scatter + respawn in one dispatch: the driver's
    single-bounce step at and below the compaction floor."""
    rec, st = _hit_core(scene, st, cfg=cfg, hit_fn=hit_fn)
    st = _scatter_core(scene, st, rec, salt, step_i, dims, cfg=cfg,
                       lean=lean)
    # Respawn draws decorrelate via their purpose tag (hash_uniform01).
    return _respawn_core(cam, st, salt, step_i, dims, cfg=cfg,
                         n_frames=n_frames, lean=lean)


# Bounces per tail multi-step program (lax.fori_loop inside one jit):
# fewer dispatches in the dispatch-bound tail.  Kept small: compile time
# grows with the unrolled program.
_MULTI_K = 4


@functools.partial(
    jax.jit, static_argnames=("cfg", "hit_fn", "n_frames", "k", "lean"))
def p_bounce_multi_step(scene: SphereScene, cam: Camera, st: PathState,
                        salt: jnp.ndarray, step0: jnp.ndarray,
                        dims: jnp.ndarray, *,
                        cfg: RenderConfig, hit_fn,
                        n_frames: int = 1, k: int = _MULTI_K,
                        lean: bool = False) -> PathState:
    """``k`` full bounces in ONE dispatch (tail economics: below the
    compaction floor the render is dispatch-bound).  ``step0`` is the
    step index of the FIRST bounce; draws are bit-identical to ``k``
    successive p_bounce_step calls at steps step0..step0+k-1."""
    def body(i, st):
        step_i = step0 + i
        rec, st = _hit_core(scene, st, cfg=cfg, hit_fn=hit_fn)
        st = _scatter_core(scene, st, rec, salt, step_i, dims, cfg=cfg,
                           lean=lean)
        return _respawn_core(cam, st, salt, step_i, dims, cfg=cfg,
                             n_frames=n_frames, lean=lean)
    return jax.lax.fori_loop(0, k, body, st)


@functools.partial(
    jax.jit, static_argnames=("cfg", "hit_fn", "n_frames", "lean"))
def p_render_oneshot(scene: SphereScene, cam: Camera, st: PathState,
                     salt: jnp.ndarray, step0: jnp.ndarray,
                     dims: jnp.ndarray, max_steps: jnp.ndarray, *,
                     cfg: RenderConfig, hit_fn,
                     n_frames: int = 1,
                     lean: bool = False) -> PathState:
    """A whole lane chunk to completion in ONE dispatch: a
    lax.while_loop over the one-program XLA bounce, terminating when
    every lane is dead (or at ``max_steps``, the same quota*(depth+2)
    bound the host loop uses).  Small renders are dispatch-bound, and
    at/below the compaction floor the host loop makes no compaction
    decisions, so moving the loop onto the device removes every host
    round trip.  The body is bounce step
    ``step+1`` with the same salt/step draw derivation, so the result
    is BIT-IDENTICAL to ``max_steps`` successive ``p_bounce_step``
    dispatches on the same state.  Vs the host driver it is identical
    only until the driver's first below-floor split/compaction event:
    those permute/extend the lane axis, and per-lane draws key on lane
    position, so subsequent draws differ (statistically equivalent
    Monte Carlo streams, same estimator).  The while body compiles once
    (XLA cannot unroll a data-dependent while), so program size stays
    at one bounce.

    ``step0`` (traced) is the step index already consumed by earlier
    dispatches — the loop's first bounce is step0+1, so draw indices
    never repeat when this finishes a render the host loop started
    (the below-floor tail finisher).  ``max_steps`` stays the chunk's
    total-step bound (traced, like dims — one compiled program per lane
    count serves every render shape), not a count of steps to run here."""
    max_s = jnp.asarray(max_steps, jnp.int32)

    def cond(carry):
        st_, step_ = carry
        return (step_ < max_s) & jnp.any(st_.path_alive)

    def body(carry):
        st_, step_ = carry
        step_ = step_ + 1
        rec, st_ = _hit_core(scene, st_, cfg=cfg, hit_fn=hit_fn)
        st_ = _scatter_core(scene, st_, rec, salt, step_, dims, cfg=cfg,
                            lean=lean)
        st_ = _respawn_core(cam, st_, salt, step_, dims, cfg=cfg,
                            n_frames=n_frames, lean=lean)
        return st_, step_

    st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(step0)))
    return st


@functools.partial(
    jax.jit, static_argnames=("cfg", "hit_fn", "n_frames", "lean"))
def p_render_until(scene: SphereScene, cam: Camera, st: PathState,
                   salt: jnp.ndarray, step0: jnp.ndarray,
                   alive_target: jnp.ndarray,
                   dims: jnp.ndarray, max_steps: jnp.ndarray, *,
                   cfg: RenderConfig, hit_fn,
                   n_frames: int = 1,
                   lean: bool = False):
    """One STAGE of the staged device-side tail (``one_shot='staged'``):
    bounce in a ``lax.while_loop`` until the alive count drops to
    ``alive_target`` (a TRACED operand — one compiled program per lane
    width serves every stage) or ``max_steps``, then hand back to the
    host for the one compact+split decision the host loop would have
    made.  Returns ``(st, step, alive_count)``.

    This keeps the tail finisher's zero-round-trips-between-events
    property (p_render_oneshot) without its weakness at large tails:
    the finisher sweeps a FIXED lane width to completion, paying
    full-width bounces long after most lanes die, whereas staged exits
    the moment one more compaction pays — with an exact device-side
    condition instead of the host loop's periodic stale-count checks.

    Do-while structure: the first bounce runs unconditionally because a
    just-split batch's clone lanes sit dead until the respawn inside the
    next bounce revives them — testing alive before stepping would exit
    immediately on entry.  Caller guarantees ``step0 < max_steps`` and
    at least one lane alive or respawnable.  Draws are bit-identical to
    successive ``p_bounce_step`` dispatches at steps step0+1.."""
    max_s = jnp.asarray(max_steps, jnp.int32)

    def bounce(carry):
        st_, step_ = carry
        step_ = step_ + 1
        rec, st_ = _hit_core(scene, st_, cfg=cfg, hit_fn=hit_fn)
        st_ = _scatter_core(scene, st_, rec, salt, step_, dims, cfg=cfg,
                            lean=lean)
        st_ = _respawn_core(cam, st_, salt, step_, dims, cfg=cfg,
                            n_frames=n_frames, lean=lean)
        return st_, step_

    def cond(carry):
        st_, step_ = carry
        alive = jnp.sum(st_.path_alive, dtype=jnp.int32)
        return (step_ < max_s) & (alive > alive_target)

    st, step = jax.lax.while_loop(cond, bounce,
                                  bounce((st, jnp.int32(step0))))
    return st, step, jnp.sum(st.path_alive, dtype=jnp.int32)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _pool_est(est: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """cfg.adaptive_pool transform of the prepass difficulty estimate:
    max(raw, 3x3 box mean)^1.2 over the chunk's (rows, width) layout.
    Plain box smoothing would dilute the hard pixels the serial tail is
    made of, so the box only ever raises an estimate, and the mild
    exponent over-allocates against the predictor's regression-to-mean."""
    img = est.reshape(h, w).astype(jnp.float32)
    pad = jnp.pad(img, 1, mode="edge")
    box = sum(pad[dy:dy + h, dx:dx + w]
              for dy in range(3) for dx in range(3)) / 9.0
    return jnp.power(jnp.maximum(img, box), np.float32(1.2)).reshape(-1)


# Enough lanes to keep the device busy: multi-frame batches pick the
# SMALLEST lanes-per-pixel that clears this (longer per-lane sample
# quotas amortize the respawn/compaction tail — the dominant term in
# frame-batched renders).
_KPP_LANE_TARGET = 1 << 21


def _resolve_kpp(cfg: RenderConfig, spp: int, n_frames: int = 1,
                 frame_pixels: int = 0) -> int:
    """cfg.lanes_per_pixel, or the auto choice — shared by the single-
    and multi-chip drivers.

    Single frame: largest of 8/4/2 dividing spp with quota >= 4 (more
    parallel lanes for hard pixels; the headline sweep's winner).

    Multi-frame batches (n_frames > 1, frame_pixels = W*H): the
    SMALLEST kpp whose total lane count reaches _KPP_LANE_TARGET —
    batching already supplies parallelism, and longer per-lane quotas
    amortize the tail.  Falls back to the single-frame rule
    when even kpp=8 cannot reach the target (parallelism-starved either
    way; prefer lanes for hard pixels)."""
    kpp = cfg.lanes_per_pixel
    if kpp <= 0:
        if n_frames > 1 and frame_pixels > 0:
            for cand in (1, 2, 4, 8):
                if spp % cand == 0 and (frame_pixels * n_frames * cand
                                        >= _KPP_LANE_TARGET):
                    return cand
        kpp = 1
        for cand in (8, 4, 2):
            if spp % cand == 0 and spp // cand >= 4:
                return cand
        return kpp
    if spp % kpp:
        raise ValueError(f"lanes_per_pixel ({kpp}) must divide samples "
                         f"({spp})")
    return kpp


# Compaction size grid: relative (mantissa) grid above the dispatch
# floor — 16 sizes per power-of-two octave (_mantissa_grid below), powers
# of two below the floor.  Fine enough that a compaction captures most of
# the alive-fraction drop (pow2 halving leaves long runs of full-size
# steps on half-dead batches) while keeping the rung-size set FIXED and
# seed-independent (the compile-surface rationale is on _mantissa_grid).
_GRID_STEPS_LOG2 = 4         # 16 grid sizes per octave
_COMPACT_QUANTUM = 1 << 16   # legacy absolute quantum (cfg.compact_quantum>0)
# Compact when the quantized live-lane batch would shrink below this
# fraction of the current batch (larger = compact more eagerly).
_COMPACT_SHRINK = 0.90
_COMPACT_FLOOR = 1 << 19     # below this, steps are dispatch-bound: never
                             # compact (it costs more than it saves)


def _multisort_state(st: PathState, key: jnp.ndarray, skip=()):
    """Stable-sort every PathState row by ``key`` in ONE multi-operand
    ``lax.sort`` (the measured-cheap way to permute the whole state —
    see _compact_core's cost note).  Returns (sorted key, {field:
    [sorted rows]}); ``skip`` omits fields the caller reconstructs
    itself.  Shared by the compactor and the bin sort so the
    operand-order bookkeeping exists exactly once."""
    ops = [key]
    row_fields = []  # (field, n_rows) in operand order
    for f in PathState._fields:
        if f in skip:
            continue
        arr = getattr(st, f)
        row_fields.append((f, arr.shape[0]))
        ops.extend(arr[i] for i in range(arr.shape[0]))
    out = jax.lax.sort(tuple(ops), dimension=0, num_keys=1, is_stable=True)
    rest = list(out[1:])
    cols = {}
    for f, rows_n in row_fields:
        cols[f] = rest[:rows_n]
        rest = rest[rows_n:]
    return out[0], cols


# Pixel-id ceiling for the composite (dead, pixel) compaction sort key:
# the dead bit rides at this weight inside one int32, so the
# argsort-free tail flush (tail_sorted) is only enabled when every
# pixel-lane id fits below it (h_virt * w * kpp < 2^30 — true for any
# realistic render; a 16K frame at kpp=8 would be the first to exceed).
_SORT_PIX_LIM = np.int32(1 << 30)


def _mantissa_grid(n: int, steps_log2: int = _GRID_STEPS_LOG2) -> int:
    """Round ``n`` UP onto the seed-independent compaction size grid:
    2**steps_log2 sizes per power-of-two octave (granularity =
    octave/2**steps_log2, so padding waste < 1/2**steps_log2, ~3% mean
    at the default 16 steps).

    Why not a fixed absolute quantum: the rung sizes a render visits are
    then ceil(alive/q)*q for runtime alive counts, i.e. DATA-DEPENDENT —
    every new seed/config walks a few never-seen sizes, each compiling
    its own copy of the step programs.  A relative (mantissa) grid has a
    FIXED, enumerable size set — ~16 sizes per octave, every octave,
    shared by all seeds, configs and image shapes — so the whole ladder
    compiles once and stays disk-cached."""
    if n <= 0:
        return 0
    # Octave (2^(bl-1), 2^bl] has width 2^(bl-1); granularity
    # width / 2^steps_log2 gives exactly 2^steps_log2 sizes per octave.
    scale = 1 << max((n - 1).bit_length() - 1 - steps_log2, 0)
    return ((n + scale - 1) // scale) * scale


def _grid_size(n_alive: int, min_lanes: int, quantum: int = 0) -> int:
    if n_alive >= _COMPACT_FLOOR:
        if quantum:
            return ((n_alive + quantum - 1) // quantum) * quantum
        # min_lanes clamp matters only in shrunken-floor test regimes
        # (production floors keep above-floor sizes >= 512k >> min_lanes,
        # and mantissa scale >= 2^14 there keeps them lane-aligned).
        return max(min_lanes, _mantissa_grid(n_alive))
    return max(min_lanes, _next_pow2(n_alive))


# ---------------------------------------------------------------------------
# Windowed flush: per-pixel accumulation of dropped-lane radiance WITHOUT
# the XLA scatter-add.  The dropped tail arrives PIXEL-SORTED (the composite sort key / argsort fallback), and a sorted
# stream can be accumulated densely: take fixed blocks of B entries,
# each covering a bounded pixel window when the stream is locally dense
# (kpp replicas make production tails dense), build the block's
# [B, W] one-hot, contract it ([3, B] x [B, W] -> [3, W]), and
# add the window into the accumulator with a dynamic-update-slice — a
# contiguous read-modify-write, no scatter.  Blocks whose pixel span
# exceeds the window (sparse stream regions) fall back to one masked
# segment_sum, executed only when such a block exists (lax.cond).
_FLUSH_BLOCK = 1024
_FLUSH_WIN = 1024 + 128   # block span bound + 128-lane base alignment


def _window_flush(accum: jnp.ndarray, pix: jnp.ndarray,
                  rad: jnp.ndarray) -> jnp.ndarray:
    """accum [3, P] += per-pixel sums of rad [3, T] at ASCENDING pixel
    ids pix [T] (i32, all < P).  Exact sums (f32 adds in block order —
    same values as segment_sum, associativity-order differences only)."""
    t = pix.shape[0]
    p = accum.shape[1]
    if t == 0:
        return accum
    b, w = _FLUSH_BLOCK, _FLUSH_WIN
    pad = (-t) % b
    if pad:
        # Pad with the LAST pixel id (keeps the stream ascending) and
        # zero radiance (contributes nothing).
        pix = jnp.concatenate([pix, jnp.broadcast_to(pix[t - 1:t], (pad,))])
        rad = jnp.pad(rad, ((0, 0), (0, pad)))
    nb = (t + pad) // b
    pix2 = pix.reshape(nb, b)
    rad2 = rad.reshape(3, nb, b).transpose(1, 0, 2)     # [nb, 3, b]
    w0 = (pix2[:, 0] // 128) * 128                       # [nb], aligned
    ok = (pix2[:, -1] - w0) < w                          # [nb] span fits
    off = pix2 - w0[:, None]                             # [nb, b]

    # Window base can reach p-1; pad the accumulator so every window
    # fits without DUS start-clamping (which would mis-map pixels).
    acc_p = jnp.pad(accum, ((0, 0), (0, w)))

    iota_w = jax.lax.iota(jnp.int32, w)

    def body(acc, xs):
        offb, radb, w0b, okb = xs
        onehot = ((offb[:, None] == iota_w[None, :]) & okb).astype(
            jnp.float32)                                  # [b, w]
        # Precision.HIGHEST: a default f32 dot may run at reduced
        # precision (TF32 on a GPU), losing radiance bits.  The one-hot
        # is exact either way; HIGHEST keeps f32 products.
        contrib = jax.lax.dot_general(
            radb, onehot, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)          # [3, w]
        win = jax.lax.dynamic_slice(acc, (0, w0b), (3, w))
        return jax.lax.dynamic_update_slice(acc, win + contrib,
                                            (0, w0b)), None

    acc_p, _ = jax.lax.scan(body, acc_p, (off, rad2, w0, ok))
    accum = acc_p[:, :p]

    def slow(acc):
        # Sparse-region residual: the overflowing blocks' entries via
        # the plain scatter-add (zeroed elsewhere).  Runs only when an
        # overflowing block exists.
        mask = jnp.repeat(~ok, b)
        r = jnp.where(mask[None, :], rad, 0.0)
        return acc + jax.ops.segment_sum(
            r.T, pix, num_segments=p, indices_are_sorted=True).T

    return jax.lax.cond(jnp.any(~ok), slow, lambda a: a, accum)


def _compact_core(st: PathState, accum: jnp.ndarray, *, k_new: int,
                  lanes_per_pixel: int = 1, tail_sorted: bool = False,
                  n_receivers: int = 0, flush: str = "scatter"):
    """Keep the live lanes (alive-first stable sort) in a [k_new] batch;
    flush ONLY the dropped lanes' radiance into the device accumulator.

    One multi-operand ``lax.sort`` carries every state row (the sorted
    output hands us the dropped tail for free); survivors keep
    accumulating in place and only the dropped tail is segment-summed
    out.

    ``tail_sorted``: promise that ``st.pixel`` is ascending (true above
    the compaction floor: chunks start pixel-identity; _split's clone
    concat, ray binning, and receiver redistribution break it).  The
    sort key then becomes the composite (dead, pixel) — same one-int32
    sort cost, pixel ids stay below ``_SORT_PIX_LIM`` by the driver's
    guard — so the compacted head is [alive asc][retained-dead asc] and
    the INVARIANT SURVIVES the compaction itself: both this call's
    dropped tail and every later compaction's tail stay ascending, and
    the flushes need no argsort.  (A dead-bit-only key broke this from
    the second compaction on: newly-dead and retained-dead lanes
    interleave, and segment_sum(indices_are_sorted=True) on a
    non-ascending tail is XLA-undefined.)

    ``n_receivers`` > 0 enables WORK REDISTRIBUTION (the above-floor
    analogue of _split): the LAST
    n_receivers lanes of the compacted batch — which the caller
    guarantees are dead (choose n_receivers <= k_new - alive_upper_bound)
    — adopt half the unstarted samples of n_receivers DONOR lanes strided
    evenly across [0, k_new - n_receivers).  Dead receivers' final
    radiance is flushed before they change pixels; sample accounting is
    exact (donor keeps quota - give, receiver gets give at
    s_base + kept).  All static shapes: strided slices, no gathers."""
    key_s, cols = _compact_partition_core(st, tail_sorted=tail_sorted)
    return _compact_finish_core(
        key_s, cols, accum, k_new=k_new, lanes_per_pixel=lanes_per_pixel,
        tail_sorted=tail_sorted, n_receivers=n_receivers, flush=flush)


def _compact_partition_core(st: PathState, *, tail_sorted: bool):
    """The compaction's SORT half: alive-first (composite-key) stable
    multisort of the full state.  Split from the finish half so the
    expensive sort-network program keys on the batch WIDTH only — the
    old fused _compact compiled the identical network once per
    (width, k_new) PAIR.  Returns (sorted key, per-field rows)."""
    key = (~st.path_alive[0]).astype(jnp.int32)
    if tail_sorted:
        key = key * _SORT_PIX_LIM + st.pixel[0]
    # path_alive is recovered from the sorted key.
    return _multisort_state(st, key, skip=("path_alive",))


def _compact_finish_core(key_s, cols, accum, *, k_new: int,
                         lanes_per_pixel=1, tail_sorted: bool = False,
                         n_receivers: int = 0, flush: str = "scatter"):
    """The compaction's cheap half: slice the [k_new] head, receiver
    redistribution, dropped-tail flush.  Keys on (width, k_new) but has
    no sort network — compiles in seconds (the per-pair surface)."""
    alive_s = (key_s[:k_new] < _SORT_PIX_LIM if tail_sorted
               else key_s[:k_new] == 0)
    new = PathState(*(
        alive_s[None] if f == "path_alive"
        else jnp.stack([r[:k_new] for r in cols[f]])
        for f in PathState._fields))

    if n_receivers > 0:
        r0 = k_new - n_receivers
        stride = max(1, r0 // n_receivers)  # donors all land in [0, r0)
        # Flush the receivers' (dead, final) radiance before they adopt
        # new pixels.  The region sits inside the sorted head, so its
        # pixels are ascending whenever the batch is.
        recv_pix, _ = _exact_divmod_any(new.pixel[0, r0:],
                                        lanes_per_pixel)
        recv_rad = new.radiance_sum[:, r0:]
        if not tail_sorted:
            order_r = jnp.argsort(recv_pix)
            recv_pix = recv_pix[order_r]
            recv_rad = jnp.take(recv_rad, order_r, axis=1)
        accum = accum + jax.ops.segment_sum(
            recv_rad.T, recv_pix, num_segments=accum.shape[1],
            indices_are_sorted=True).T

        # Donor update: every lane at a donor position gives away half
        # its unstarted samples (dead donors give 0).
        give_full = jnp.maximum(new.s_quota - 1 - new.sample, 0) // 2
        pos = jnp.arange(k_new, dtype=jnp.int32)
        is_donor = ((pos % stride == 0)
                    & (pos // stride < n_receivers))[None]
        quota_kept = jnp.where(is_donor, new.s_quota - give_full,
                               new.s_quota)

        def don(row):  # [1, k_new] -> the n_receivers donor values
            return row[:, ::stride][:, :n_receivers]

        new = new._replace(
            s_quota=quota_kept.at[:, r0:].set(don(give_full)),
            s_base=new.s_base.at[:, r0:].set(
                don(new.s_base) + don(quota_kept)),
            pixel=new.pixel.at[:, r0:].set(don(new.pixel)),
            sample=new.sample.at[:, r0:].set(-1),
            depth=new.depth.at[:, r0:].set(0),
            throughput=new.throughput.at[:, r0:].set(1.0),
            radiance_sum=new.radiance_sum.at[:, r0:].set(0.0),
            path_alive=new.path_alive.at[:, r0:].set(False),
        )

    # Dropped lanes are all dead (k_new >= n_alive): radiance is final.
    drop_pix, _ = _exact_divmod_any(cols["pixel"][0][k_new:],
                                    lanes_per_pixel)
    drop_rad = jnp.stack([r[k_new:] for r in cols["radiance_sum"]])
    if not tail_sorted:
        order = jnp.argsort(drop_pix)
        drop_pix = drop_pix[order]
        drop_rad = jnp.take(drop_rad, order, axis=1)
    # Either way the dropped stream is now pixel-ascending: the windowed
    # flush applies.
    if flush == "window":
        return new, _window_flush(accum, drop_pix, drop_rad)
    flushed = jax.ops.segment_sum(
        drop_rad.T, drop_pix,
        num_segments=accum.shape[1], indices_are_sorted=True)
    return new, accum + flushed.T


# lanes_per_pixel rides as a TRACED operand (it only feeds pixel-id
# division in the flushes), so one compiled compaction per
# (n_in, k_new, flags) serves every config and every kpp.
# lanes_per_pixel rides as a TRACED operand in the finish program.  The
# two-program split means a fresh (width, k_new) pair only compiles the
# cheap finish; the sort network compiles once per width.
_compact_partition = functools.partial(
    jax.jit, static_argnames=("tail_sorted",))(_compact_partition_core)
_compact_finish = functools.partial(
    jax.jit, static_argnames=("k_new", "tail_sorted", "n_receivers",
                              "flush"))(_compact_finish_core)


def _compact(st: PathState, accum, *, k_new, lanes_per_pixel=1,
             tail_sorted=False, n_receivers=0, flush="scatter"):
    """Two-dispatch compaction (sort-by-width, finish-by-pair); the
    intermediate sorted state crosses device memory once and both
    dispatches pipeline."""
    key_s, cols = _compact_partition(st, tail_sorted=tail_sorted)
    return _compact_finish(key_s, cols, accum, k_new=k_new,
                           lanes_per_pixel=lanes_per_pixel,
                           tail_sorted=tail_sorted,
                           n_receivers=n_receivers, flush=flush)


# ---------------------------------------------------------------------------
# Router compactor (cfg.compactor="route"): stable partition WITHOUT the
# sort network.  The 20-operand lax.sort in _compact_core carries both the
# compaction's runtime and its compile cost.  A stable partition by ONE bit needs neither: route
# every alive column left by (dead columns before it) with ceil(log2 n)
# masked power-of-two shifts — a monotone routing, so LSB-first
# bit-serial shifting is collision-free (proof sketch: for alive i < j,
# dest_j - dest_i >= 1 forces shift_j - shift_i <= j - i - 1, so j's
# partial position j - (s_j mod 2^k) stays > i's for every prefix of
# bits).  Dead columns route right symmetrically.
#
# Equivalence to the sort compactor: a stable partition preserves the
# alive group's relative order, which is exactly what lax.sort with the
# dead-bit key (is_stable) produces — and equals the composite
# (dead, pixel) key's alive ordering whenever the driver's pixel-
# ascending invariant holds (the only time tail_sorted is passed).  The
# surviving lanes therefore land in IDENTICAL slots and the continuing
# render is bit-identical (per-lane draws key on lane position).  Only
# the retained-dead region differs: those lanes are inert by
# construction (a lane observed dead at a host check has exhausted its
# quota — in-kernel respawn would have revived it otherwise), so the
# router re-synthesizes them as explicit zero-quota padding (pixel and
# radiance preserved for the eventual flush; sample=0, s_quota=0 can
# never pass the respawn predicate sample < s_quota - 1) instead of
# routing 12 more state rows to the tail.  The dropped tail's flush
# uses an UNSORTED segment_sum: the router's dead group is multi-run
# (one ascending run per prior compaction), not globally
# pixel-ascending.
_ROUTE_F32_FIELDS = ("origin", "direction", "time", "throughput",
                     "radiance_sum")
_ROUTE_I32_FIELDS = ("depth", "sample", "pixel", "s_base", "s_quota")
# Row offsets: f32 stack [13, n] and i32 stack [5, n] (separate stacks —
# see _route_partition's denormal note).
_R_RAD = 10
_RI_DEPTH, _RI_SAMPLE, _RI_PIXEL, _RI_SBASE, _RI_SQUOTA = 0, 1, 2, 3, 4


def _route_partition(mats, shift: jnp.ndarray,
                     valid: jnp.ndarray, *, right: bool = False):
    """Stable-compact the columns of each matrix in ``mats`` (same
    width, any dtype) where ``valid`` is nonzero to the left (or right)
    edge.  ``shift`` [n] i32 is each valid column's non-negative move
    distance (garbage on invalid columns — never consulted).  Returns
    the routed matrices; after routing, the first (last) n_valid
    columns hold the valid columns in stable order.

    Matrices keep their OWN dtype through the routing: i32 rows bitcast
    as f32 would be small-integer denormals, which hardware that flushes
    denormals on select zeroes."""
    mats = list(mats)
    n = mats[0].shape[1]
    for k in range(max(1, (n - 1).bit_length())):
        s = 1 << k
        if right:
            def sh(a):
                pad = [(0, 0)] * (a.ndim - 1) + [(s, 0)]
                return jnp.pad(a[..., :n - s], pad)
        else:
            def sh(a):
                pad = [(0, 0)] * (a.ndim - 1) + [(0, s)]
                return jnp.pad(a[..., s:], pad)
        arrive = (sh(valid) > 0) & (((sh(shift) >> k) & 1) > 0)
        leave = (valid > 0) & (((shift >> k) & 1) > 0)
        mats = [jnp.where(arrive[None, :], sh(m), m) for m in mats]
        shift = jnp.where(arrive, sh(shift), shift)
        valid = jnp.where(arrive, jnp.int32(1),
                          jnp.where(leave, jnp.int32(0), valid))
    return mats


def _compact_route_core(st: PathState, accum: jnp.ndarray, *, k_new: int,
                        lanes_per_pixel=1):
    """Drop-in for _compact_core (sans receiver redistribution — the
    driver falls back to the sort compactor for those events): keep the
    live lanes in a [k_new] batch, flush the dropped lanes' radiance."""
    n = st.pixel.shape[1]
    alive = st.path_alive[0]
    alive_i = alive.astype(jnp.int32)
    dead_i = 1 - alive_i
    pos = jax.lax.iota(jnp.int32, n)
    ca = jnp.cumsum(alive_i)
    n_alive = ca[n - 1]

    mat_f = jnp.concatenate(
        [getattr(st, f) for f in _ROUTE_F32_FIELDS], axis=0)   # [13, n]
    mat_i = jnp.concatenate(
        [getattr(st, f) for f in _ROUTE_I32_FIELDS], axis=0)   # [5, n]
    mat_f, mat_i = _route_partition((mat_f, mat_i), pos - (ca - 1),
                                    alive_i)

    # Dead columns: only pixel + radiance survive (flush payload); the
    # rest of a dead lane's state is re-synthesized as inert padding.
    cd = jnp.cumsum(dead_i)
    shift_d = (n_alive + cd - 1) - pos
    d_rad, d_pix = _route_partition(
        (st.radiance_sum, st.pixel), shift_d, dead_i, right=True)

    ha = (pos[:k_new] < n_alive)[None]          # [1, k_new]
    f_h = mat_f[:, :k_new]
    i_h = mat_i[:, :k_new]
    zero_i = jnp.zeros((1, k_new), jnp.int32)
    dir_pad = jnp.zeros((3, k_new), jnp.float32).at[2].set(1.0)

    def head_i32(row):
        return jnp.where(ha, i_h[row:row + 1], zero_i)

    new = PathState(
        origin=jnp.where(ha, f_h[0:3], 0.0),
        direction=jnp.where(ha, f_h[3:6], dir_pad),
        time=jnp.where(ha, f_h[6:7], 0.0),
        throughput=jnp.where(ha, f_h[7:10], 1.0),
        radiance_sum=jnp.where(ha, f_h[_R_RAD:_R_RAD + 3],
                               d_rad[:, :k_new]),
        depth=head_i32(_RI_DEPTH),
        sample=head_i32(_RI_SAMPLE),
        pixel=jnp.where(ha, i_h[_RI_PIXEL:_RI_PIXEL + 1],
                        d_pix[:, :k_new]),
        path_alive=ha,
        s_base=head_i32(_RI_SBASE),
        s_quota=head_i32(_RI_SQUOTA),
    )

    # Dropped tail: all dead (k_new >= n_alive), radiance final.
    drop_pix, _ = _exact_divmod_any(d_pix[0:1, k_new:], lanes_per_pixel)
    flushed = jax.ops.segment_sum(
        d_rad[:, k_new:].T, drop_pix[0],
        num_segments=accum.shape[1], indices_are_sorted=False)
    return new, accum + flushed.T


_compact_route = functools.partial(
    jax.jit, static_argnames=("k_new",))(_compact_route_core)

# Work redistribution at above-floor compactions: overshoot k_new by
# this factor and hand the spare dead lanes donor work.  Off by default
# (cfg.redistribute).
_RECV_OVERSHOOT = 1.25
_RECV_MIN = 1 << 16


# Ray binning (mesh / grid-accelerated scenes): per-bounce spatial sort.
# Block-schedule accel structures are only as good as each ray block's
# coherence — on scattered bounce-like rays the tri grid's conservative
# per-block mask degenerates to ALL tiles active.  Sorting the path state
# by (Morton cell of origin, direction octant) before each hit phase packs
# each ray block into a tight spatial wedge, so block AABB unions shrink
# back to a few tiles.  Same multi-operand lax.sort as the compactor.
# Exhausted (dead) lanes sort to the end AND get their rays parked
# outside every AABB, so all-dead blocks admit no tiles.
_BIN_CELLS = 8  # per axis; 9-bit Morton + 3-bit octant = 4096 buckets
# Sort every Nth bounce step.  1 = every hit phase gets fresh bins; at
# >1 the blocks go stale between sorts (origins stay local after one
# scatter, directions decohere) in exchange for amortizing the 19-operand
# sort's cost over N hit phases.  A/B knob for the mesh-scene economics.
_BIN_PERIOD = 1
# Sort-key variant.  "pos4+exit4+oct" keys each ray by (coarse origin
# cell, coarse CHORD-EXIT cell, direction octant) — the exit cell is
# where the ray's t-segment leaves the accel AABB, so rays grouped
# together share whole chords, not just starting points (primaries all
# share the camera's position cell, so an origin-only key cannot tell
# them apart).
_BIN_KEY = "pos4+exit4+oct"  # | "pos8+oct" (origin-only key, A/B arm)


def _bin_sort_core(st: PathState, *, box, key_variant=None) -> PathState:
    """One stable multisort of the whole state by chord bucket.

    ``box`` = (lo_x, lo_y, lo_z, inv_ext_x, inv_ext_y, inv_ext_z) of the
    accel structure's scene AABB (static floats; one program per scene).
    Lane permutation is already an accepted scheduler behavior (the
    compactor permutes lanes mid-render): per-sample RNG draws change
    with lane position, so images match unbinned renders statistically,
    not bitwise — exactly like a different compaction cadence."""
    alive = st.path_alive
    o, d = st.origin, st.direction

    def cells(p, n_c):
        cs = []
        for ax in range(3):
            c = ((p[ax] - np.float32(box[ax]))
                 * np.float32(box[3 + ax] * n_c)).astype(jnp.int32)
            cs.append(jnp.clip(c, 0, n_c - 1))
        return cs

    def spread3(v):  # 3-bit value -> bits at positions 0, 3, 6
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)

    def morton(cs):
        return (spread3(cs[0]) | (spread3(cs[1]) << 1)
                | (spread3(cs[2]) << 2))

    octant = ((d[0] < 0).astype(jnp.int32)
              | ((d[1] < 0).astype(jnp.int32) << 1)
              | ((d[2] < 0).astype(jnp.int32) << 2))
    if key_variant is None:
        key_variant = _BIN_KEY
    if key_variant == "pos4+exit4+oct":
        # Chord exit point: slab test against the accel AABB (hi side =
        # lo + 1/inv_ext); exit = o + hi_t*d, hi_t >= 0.
        eps = np.float32(1e-12)
        hi_t = jnp.full_like(o[0], np.float32(1e8))
        for ax in range(3):
            dn = jnp.where(jnp.abs(d[ax]) < eps,
                           jnp.where(d[ax] < 0, -eps, eps), d[ax])
            lo_p = np.float32(box[ax])
            hi_p = np.float32(box[ax] + 1.0 / box[3 + ax])
            ta = (lo_p - o[ax]) / dn
            tb = (hi_p - o[ax]) / dn
            hi_t = jnp.minimum(hi_t, jnp.maximum(ta, tb))
        hi_t = jnp.maximum(hi_t, 0.0)
        exit_p = [o[ax] + hi_t * d[ax] for ax in range(3)]
        key_val = ((morton(cells(o, 4)) << 9)
                   | (morton(cells(exit_p, 4)) << 3) | octant)
    else:  # "pos8+oct" — the origin-only key
        key_val = (morton(cells(o, _BIN_CELLS)) << 3) | octant
    key = jnp.where(alive[0], key_val, jnp.int32(1 << 20))

    # Park dead lanes' rays below everything with an empty footprint;
    # respawn overwrites the ray whenever the lane spawns a new sample, and
    # every consumer of a dead lane's hit record is masked, so the ray
    # itself is free state.
    park_o = jnp.asarray([0.0, -1e9, 0.0], jnp.float32)[:, None]
    park_d = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)[:, None]
    st = st._replace(origin=jnp.where(alive, o, park_o),
                     direction=jnp.where(alive, d, park_d))

    _, cols = _multisort_state(st, key)
    return PathState(**{f: jnp.stack(rows) for f, rows in cols.items()})


_bin_sort = functools.partial(
    jax.jit, static_argnames=("box", "key_variant"))(_bin_sort_core)


def _tri_rebin_active(cfg, scene):
    """True when the two-phase triangle working-set rebin (cfg.tri_rebin
    'on'/'dda', kernels/tri_rebin.py) applies to this scene — i.e. the
    triangle side carries a TriGridScene.  Shared by _derive_bin_box and
    both drivers' one_shot conflict checks (checking ``bin_box`` alone
    misses it: _derive_bin_box deliberately returns None under tri
    rebin, so the conflict must probe the cfg/scene directly)."""
    from .tri_accel import TriGridScene
    g = scene if isinstance(scene, TriGridScene) else getattr(
        scene, "triangles", None)
    return isinstance(g, TriGridScene) and cfg.tri_rebin in ("on", "dda")


def _derive_bin_box(cfg, scene):
    """Ray-binning AABB: on (auto) whenever the scene carries a
    block-schedule accel structure whose mask needs coherent blocks (see
    _bin_sort); None when binning is off or inapplicable.  Shared by the
    single-chip and sharded drivers (parallel/persistent_shard.py)."""
    if cfg.ray_binning == "off":
        return None
    from .tri_accel import TriGridScene
    g = scene if isinstance(scene, TriGridScene) else getattr(
        scene, "triangles", None)
    if _tri_rebin_active(cfg, scene):
        # The two-phase hit fn sorts its own working set with occlusion
        # knowledge (kernels/tri_rebin.py); driver-level state binning
        # would just pay a redundant 19-row sort on top.
        return None
    if isinstance(g, TriGridScene):
        sb_ = np.asarray(g.scene_box, np.float64)
        lo3 = sb_[0::2]
        ext = np.maximum(sb_[1::2] - sb_[0::2], 1e-6)
    elif cfg.ray_binning == "on":
        raise ValueError(
            "ray_binning='on' needs a grid-accelerated scene "
            f"(got {type(scene).__name__})")
    else:
        return None
    return (float(lo3[0]), float(lo3[1]), float(lo3[2]),
            float(1.0 / ext[0]), float(1.0 / ext[1]),
            float(1.0 / ext[2]))


@jax.jit
def _split(st: PathState) -> PathState:
    """Sample splitting: hand half of every lane's *unstarted* samples to a
    clone lane, doubling tail parallelism at exact sample accounting
    (sum of quotas per pixel is invariant).  Clones start dead with an
    empty path and respawn on the next step; lanes with <2 unstarted
    samples produce zero-quota clones that never run."""
    give = jnp.maximum(st.s_quota - 1 - st.sample, 0) // 2
    keep_quota = st.s_quota - give
    clone = st._replace(
        throughput=jnp.ones_like(st.throughput),
        radiance_sum=jnp.zeros_like(st.radiance_sum),
        depth=jnp.zeros_like(st.depth),
        sample=jnp.full_like(st.sample, -1),
        path_alive=jnp.zeros_like(st.path_alive),
        s_base=st.s_base + keep_quota,
        s_quota=give,
    )
    orig = st._replace(s_quota=keep_quota)
    return PathState(*(jnp.concatenate([a, b], axis=1)
                       for a, b in zip(orig, clone)))


def render_image_persistent(
    scene: SphereScene,
    cam: Optional[Camera],
    cfg: RenderConfig,
    hit_fn=None,
    resume_accum: Optional[jnp.ndarray] = None,
    resume_y0: int = 0,
    chunk_callback=None,
) -> jnp.ndarray:
    """Render the full image; returns linear radiance [H, W, 3] f32.

    Checkpoint/resume hooks (the reference persists only out.bmp,
    Game.cpp:104 — long renders here can persist partial work):

    * ``chunk_callback(accum, next_y0)`` fires after each row-chunk's
      radiance is flushed; ``accum`` is the running [3, H*W] f32 device
      accumulator and ``next_y0`` the first unrendered row.
    * ``resume_accum`` / ``resume_y0`` continue a render from a saved
      (accum, next_y0) pair.  Per-chunk RNG salts depend only on
      (seed, y0), so a resumed render is bit-identical to an
      uninterrupted one.

    Multi-frame batching: pass a LIST of cameras as ``cam`` to render
    len(cam) animation frames in ONE batch (virtual image of height
    F*height; scheduler tail, alive-check syncs, and the dispatch floor
    amortize over all frames).  Returns [F, H, W, 3].
    """
    cams = None
    n_frames = 1
    if isinstance(cam, (list, tuple)) and not isinstance(cam, Camera):
        cams = list(cam)
        n_frames = len(cams)
        if n_frames == 1:
            # A singleton batch (e.g. the odd tail of an even frame
            # split) renders as a plain single-camera image; only the
            # [1, H, W, 3] return contract remembers the list-ness.
            cam = cams[0]
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    if hit_fn is None:
        # May swap the scene for its accelerated form (a triangle grid);
        # the scatter/respawn steps ignore scene fields so the swap is free.
        from .kernels.dispatch import get_hit_fn_rows_accel
        scene, hit_fn = get_hit_fn_rows_accel(
            cfg, scene, cams[0] if cams else cam)

    bin_box = _derive_bin_box(cfg, scene)
    if cfg.compact_quantum < 0:
        # A negative quantum makes _grid_size round DOWN (Python floor
        # division), silently dropping live lanes at compaction.
        raise ValueError(f"compact_quantum must be >= 0 (0 = auto), got "
                         f"{cfg.compact_quantum}")
    if not (cfg.compact_shrink == 0.0 or 0.0 < cfg.compact_shrink < 1.0):
        raise ValueError(f"compact_shrink must be 0 (auto) or in (0, 1), "
                         f"got {cfg.compact_shrink}")
    shrink = cfg.compact_shrink or _COMPACT_SHRINK
    w, h, spp = cfg.width, cfg.height, cfg.samples
    h_virt = h * n_frames  # multi-frame: frames stack as a taller image
    if n_frames > 1:
        # Step programs consume a frame-stacked Camera ([F]-leading fields).
        cam_x = Camera(*(jnp.stack([jnp.asarray(getattr(c, f), jnp.float32)
                                    for c in cams])
                         for f in Camera._fields))
    else:
        cam_x = cam
    # Replica lanes per pixel (multi-frame batches prefer quota over
    # replicas — _resolve_kpp rationale).
    kpp = _resolve_kpp(cfg, spp, n_frames, w * h)
    rows = max(1, min(h_virt, cfg.rays_per_chunk // max(1, w * kpp)))
    seed = cfg.seed
    # Step programs take the NORMALIZED config (step_cfg) as their static
    # argument and everything shape-like through the traced dims operand:
    # seed, image dims, spp, kpp, max_depth, RR, stratify, and every
    # driver knob share one compiled program set per lane count.
    scfg = step_cfg(cfg)
    # Static lean flag: when this render cannot stratify (off, or
    # spp == 1) and cannot Russian-roulette, the step programs compile
    # those blocks OUT instead of running their traced identity forms —
    # bit-exact by the (kx, ky) == (1, 1) / rr_start > max_depth
    # identities.  Two values only, so the compile surface stays bounded.
    lean = not (cfg.stratify and spp > 1) and not cfg.russian_roulette
    if h_virt * w * kpp >= (1 << 29):
        # The XLA cores decode pixel-lane ids with the two-stage f32
        # reciprocal divmod (_exact_divmod_any), exact below 2^29.
        # Margin: at the auto multi-frame kpp of 1, 4K x 8 frames is
        # 66.4M lanes (8x headroom); an EXPLICIT kpp=8 on that shape is
        # 530.8M — 99% of the bound, which is why this fails fast
        # instead of silently misrouting pixels.
        raise ValueError(
            f"pixel-lane ids must stay below 2^29 "
            f"(width*height*frames*lanes_per_pixel = {h_virt * w * kpp})")
    # Nothing can finish before its quota of samples is consumed (each
    # sample is >= 1 step), so the first alive check waits that long; after
    # that, check often — a sync costs about as much as a full-batch step.
    quota = spp // kpp
    check_period = cfg.check_period or 8
    first_check = quota + 2
    max_steps = (quota + 1) * (cfg.max_depth + 2)
    min_lanes = 1 << 12

    if resume_accum is not None:
        accum = jnp.asarray(resume_accum, jnp.float32)
        assert accum.shape == (3, h_virt * w), accum.shape
    else:
        accum = jnp.zeros((3, h_virt * w), jnp.float32)  # rows, like state

    # Difficulty-adaptive lane allocation (adaptive.py): a quota-1
    # prepass measures per-pixel path length, then the remaining samples
    # run on lanes allocated proportional to difficulty.  Lane encoding
    # for the adaptive phase is raw pixel ids (lanes_per_pixel=1; replica
    # bookkeeping lives entirely in s_base/s_quota).
    adaptive = (cfg.adaptive_alloc == "on"
                and kpp > 1 and spp > kpp and bin_box is None)
    if cfg.adaptive_alloc == "on" and not adaptive:
        raise ValueError(
            "adaptive_alloc='on' needs an unbinned render with "
            "lanes_per_pixel > 1 and samples > lanes_per_pixel "
            f"(got kpp={kpp}, samples={spp}, "
            f"ray_binning={'active' if bin_box else 'off'})")
    if cfg.adaptive_pool not in ("auto", "on", "off"):
        raise ValueError(
            f"adaptive_pool must be auto|on|off, got {cfg.adaptive_pool!r}")
    if adaptive:
        from .adaptive import alloc_lanes

    # One-shot programs (p_render_oneshot): below-floor chunks run
    # whole in one device-side while_loop; above-floor chunks hand
    # their below-floor tail to the same program (make_finish).
    # Features that need the host loop BETWEEN steps conflict outright:
    # per-period bin sorts and triangle working-set sorts.  The adaptive two-phase driver is NOT a
    # conflict — its phase 2 is an ordinary run_loop and takes the tail
    # finisher; only the whole-chunk form is skipped under adaptive.
    one_shot = cfg.one_shot
    if one_shot not in ("auto", "on", "off", "staged"):
        raise ValueError(
            f"one_shot must be auto|on|off|staged, got {one_shot!r}")
    _os_conflicts = [name for cond, name in (
        (bin_box is not None, "ray binning"),
        (_tri_rebin_active(cfg, scene), "tri_rebin working-set sorts"),
    ) if cond]
    if one_shot in ("on", "staged") and _os_conflicts:
        raise ValueError(f"one_shot={one_shot!r} conflicts with "
                         + ", ".join(_os_conflicts))
    if one_shot == "auto":
        # Resolved "chunk": whole-chunk while_loops only, for chunks that
        # START at/below the floor.  The above-floor TAIL finisher is
        # explicit-"on" only.
        one_shot = "off" if _os_conflicts else "chunk"

    def make_steps(salt, kpp_s):
        """Bind the bounce-step closures to a draw salt and lane
        encoding (kpp_s: pixel-lane id stride; 1 = raw pixel ids)."""
        dims_s = make_dims(cfg, w, h, spp, kpp_s)

        def do_steps(st, k, step):
            cur = st.pixel.shape[1]
            # Tail regime (<= floor): one program per bounce, and
            # multi-bounce programs (fori_loop over MULTI_K bounces) to
            # cut the dispatch count.  Binned scenes take single steps
            # everywhere: a multi-bounce program would run bounces 2..K
            # on bins gone stale after one scatter.
            fuse = cur <= _COMPACT_FLOOR
            mk = cfg.multi_k or _MULTI_K
            if fuse and k >= mk and bin_box is None:
                while k >= mk:
                    st = p_bounce_multi_step(
                        scene, cam_x, st, salt, jnp.int32(step + 1),
                        dims_s, cfg=scfg, hit_fn=hit_fn,
                        n_frames=n_frames, k=mk, lean=lean)
                    step += mk
                    k -= mk
            for _ in range(k):
                step += 1
                if bin_box is not None and (step - 1) % _BIN_PERIOD == 0:
                    # key_variant passed as a static arg so flipping the
                    # module global retraces (in-process A/B support).
                    st = _bin_sort(st, box=bin_box, key_variant=_BIN_KEY)
                if fuse:
                    st = p_bounce_step(scene, cam_x, st, salt,
                                       jnp.int32(step), dims_s,
                                       cfg=scfg, hit_fn=hit_fn,
                                       n_frames=n_frames, lean=lean)
                else:
                    # Two dispatches per bounce above the floor: the hit
                    # phase, then scatter+respawn fused.
                    rec, st = p_hit_step(scene, st, cfg=scfg,
                                         hit_fn=hit_fn)
                    st = p_scatter_respawn_step(
                        scene, cam_x, st, rec, salt, jnp.int32(step),
                        dims_s, cfg=scfg, n_frames=n_frames, lean=lean)
            return st, step

        return do_steps

    use_route = (cfg.compactor or "sort") == "route"
    flush_mode = cfg.flush_mode or "scatter"

    def compact_fn(st, accum, *, k_new, lanes_per_pixel,
                   tail_sorted=False, n_receivers=0):
        """Engine dispatch (cfg.compactor): the router produces the
        identical surviving-lane layout (continuation bit-identical —
        rationale on _compact_route_core), so the choice is purely a
        cost knob; receiver events keep the sort engine (the router has
        no redistribution path)."""
        if use_route and n_receivers == 0:
            return _compact_route(st, accum, k_new=k_new,
                                  lanes_per_pixel=lanes_per_pixel)
        return _compact(st, accum, k_new=k_new,
                        lanes_per_pixel=lanes_per_pixel,
                        tail_sorted=tail_sorted, n_receivers=n_receivers,
                        flush=flush_mode)

    def make_finish(salt, kpp_s):
        """Tail finisher: once the batch is below the compaction floor
        (dispatch-bound regime — step cost no longer shrinks with the
        batch), run the REST of the chunk as one device-side while_loop
        (p_render_oneshot with the already-consumed step offset) instead
        of host-checked multi-bounce dispatches: no dispatch or
        alive-check sync is left in the tail."""
        dims_s = make_dims(cfg, w, h, spp, kpp_s)

        def finish(st, step, max_steps_):
            return p_render_oneshot(
                scene, cam_x, st, salt, jnp.int32(step), dims_s,
                jnp.int32(max_steps_), cfg=scfg, hit_fn=hit_fn,
                n_frames=n_frames, lean=lean)
        return finish

    def make_staged(salt, kpp_s):
        """Staged device-side tail (one_shot='staged'): each stage is
        one p_render_until while_loop that exits when the alive count
        reaches the floor-pow2 of half the width (the exact point at
        which the host loop's below-floor compact+split condition
        k_new <= cur//2 first holds), then the host does that one
        compact+split and re-enters.  No periodic host checks, no
        stale-count overshoot, no fixed-width dead-lane sweeps."""
        dims_s = make_dims(cfg, w, h, spp, kpp_s)

        def staged(st, accum, step, max_steps_):
            while step < max_steps_:
                cur = st.pixel.shape[1]
                if cur <= 2 * min_lanes:
                    # Can't usefully halve further: finish the chunk in
                    # one while_loop (the plain one-shot form).
                    st = p_render_oneshot(
                        scene, cam_x, st, salt, jnp.int32(step), dims_s,
                        jnp.int32(max_steps_), cfg=scfg, hit_fn=hit_fn,
                        n_frames=n_frames, lean=lean)
                    break
                # Floor-pow2 of cur//2: guarantees _next_pow2(alive) <=
                # cur//2 at exit, i.e. the same halving the host loop
                # waits for (non-pow2 chunk widths included).
                target = 1 << (max(cur // 2, 1).bit_length() - 1)
                st, stp, cnt = p_render_until(
                    scene, cam_x, st, salt, jnp.int32(step),
                    jnp.int32(target), dims_s, jnp.int32(max_steps_),
                    cfg=scfg, hit_fn=hit_fn, n_frames=n_frames,
                    lean=lean)
                step = int(stp)
                n_alive = int(cnt)
                if n_alive == 0 or step >= max_steps_:
                    break
                k_new = max(min_lanes, _next_pow2(n_alive))
                st, accum = compact_fn(st, accum, k_new=k_new,
                                       lanes_per_pixel=kpp_s)
                st = _split(st)
            return st, accum
        return staged

    def run_loop(st, accum, do_steps, *, kpp_s, first_check, max_steps,
                 state_sorted, finish=None, staged_fn=None):
        """The check/compact/split driver loop for one lane batch."""
        step = 0
        period = check_period
        last_alive = st.pixel.shape[1]
        while step < max_steps:
            next_check = first_check if step < first_check else (
                step + period)
            st, step = do_steps(st, min(next_check, max_steps) - step, step)
            cur = st.pixel.shape[1]
            # Overlapped alive check: dispatch the count, hide its round
            # trip behind a few optimistic steps, then read.
            # The count is stale by only those steps; alive is monotone
            # non-increasing within a chunk, so it is an upper bound —
            # termination (stale 0 => now 0) and compaction sizing (an
            # overestimate keeps spare lanes) both stay correct.
            cnt = jnp.sum(st.path_alive, dtype=jnp.int32)
            try:
                cnt.copy_to_host_async()
            except Exception:  # backend without async fetch: read blocks
                pass
            ov = 1 if cur >= (1 << 21) else (2 if cur >= (1 << 20) else 4)
            st, step = do_steps(st, min(ov, max_steps - step), step)
            n_alive = int(cnt)
            if n_alive == 0:
                break
            # Adaptive cadence: back off while the alive count plateaus,
            # re-engage when it starts dropping.  Below the compaction
            # floor the only decision left is termination.
            # (an explicit cfg.check_period above 32 raises the tail
            # back-off cap too — the rarer-checks A/B knob)
            if cur < _COMPACT_FLOOR:
                period = max(32, check_period)
            elif n_alive > 0.9 * last_alive:
                period = min(period * 2, max(32, check_period))
            else:
                period = check_period
            last_alive = n_alive
            if cur <= _COMPACT_FLOOR:
                if staged_fn is not None:
                    # Staged tail: device-side while_loops between
                    # compact+split events (exact alive-halving exit
                    # condition) — see make_staged.
                    st, accum = staged_fn(st, accum, step, max_steps)
                    break
                if finish is not None:
                    # One-shot tail: compact+split once if it would fire
                    # anyway (drops the dead tail and halves hard-pixel
                    # sample quotas), then finish the chunk in ONE
                    # device-side while_loop — no further host round
                    # trips.
                    k_new = max(min_lanes, _next_pow2(n_alive))
                    if k_new <= cur // 2:
                        st, accum = compact_fn(st, accum, k_new=k_new,
                                               lanes_per_pixel=kpp_s)
                        st = _split(st)
                    st = finish(st, step, max_steps)
                    break
                # Dispatch-bound regime: step cost no longer shrinks with
                # the batch, so instead of compacting, SPLIT — drop dead
                # lanes and hand every lane's unstarted samples to clone
                # lanes.  Batch size is preserved but the remaining
                # sequential sample tail halves per event.
                k_new = max(min_lanes, _next_pow2(n_alive))
                if k_new <= cur // 2:
                    st, accum = compact_fn(st, accum, k_new=k_new,
                                           lanes_per_pixel=kpp_s)
                    st = _split(st)
                continue
            # Compact on a shrink (above the floor shrinking the batch is
            # the whole point — steps are compute-bound).  With receiver
            # redistribution, k_new overshoots so the spare dead lanes
            # adopt donor work (halved sequential tails for hard pixels).
            k_base = _grid_size(n_alive, min_lanes, cfg.compact_quantum)
            if k_base <= int(cur * shrink):
                k_new, n_recv = k_base, 0
                if cfg.redistribute == "on" and _RECV_OVERSHOOT > 0:
                    k_new = min(
                        _grid_size(int(n_alive * _RECV_OVERSHOOT),
                                   min_lanes, cfg.compact_quantum), cur)
                    spare = k_new - n_alive
                    if spare >= _RECV_MIN:
                        n_recv = min(1 << (spare.bit_length() - 1),
                                     k_new // 2)
                    else:
                        k_new = k_base
                st, accum = compact_fn(st, accum, k_new=k_new,
                                       lanes_per_pixel=kpp_s,
                                       tail_sorted=state_sorted,
                                       n_receivers=n_recv)
                if n_recv:
                    state_sorted = False
        return st, accum

    def fresh_state(n, pixel, s_base, s_quota):
        return PathState(
            origin=jnp.zeros((3, n), jnp.float32),
            direction=jnp.zeros((3, n), jnp.float32).at[2, :].set(1.0),
            time=jnp.zeros((1, n), jnp.float32),
            throughput=jnp.ones((3, n), jnp.float32),
            radiance_sum=jnp.zeros((3, n), jnp.float32),
            depth=jnp.zeros((1, n), jnp.int32),
            sample=jnp.full((1, n), -1, jnp.int32),
            pixel=pixel,
            path_alive=jnp.zeros((1, n), bool),
            s_base=s_base,
            s_quota=s_quota,
        )

    def padded_pixels(y0, n_real, pad):
        """Chunk pixel-lane ids, identity order, plus ``pad`` dead filler
        lanes REPEATING the last id (ascending order survives, so the
        tail_sorted flush invariant holds).  Fillers carry zero quota and
        never respawn; the first compaction drops them."""
        base = y0 * w * kpp
        ids = jnp.arange(base, base + n_real, dtype=jnp.int32)
        if pad:
            ids = jnp.concatenate(
                [ids, jnp.full((pad,), base + n_real - 1, jnp.int32)])
        return ids[None]

    for y0 in range(resume_y0, h_virt, rows):
        take = min(rows, h_virt - y0)
        n_real = take * w * kpp
        # Pad the chunk onto the COMPACTION SIZE GRID (_grid_size): every
        # chunk of every image size then starts at a ladder size the
        # compile cache already owns, instead of compiling step programs
        # for a per-config lane count.  The filler lanes (< one quantum,
        # <= 1.6% at production chunks) are dead on arrival and dropped
        # by the first compaction; real lanes keep their positions, so
        # draws are unchanged.
        n = _grid_size(n_real, min_lanes, cfg.compact_quantum)
        pad = n - n_real
        salt = np.uint32((seed * 0x9E3779B1 ^ (y0 + 1) * 0x85EBCA77)
                         & 0xFFFFFFFF)
        if adaptive:
            # Phase 1 (prepass): kpp quota-1 lanes per pixel.  Every path
            # is dead after max_depth+1 bounces, so the phase runs a
            # STATIC step count — zero device syncs — and, uncompacted,
            # the final depth row is the per-sample path length in
            # pixel-identity order (reshape-sum, no gather; filler lanes
            # sit past n_real and are sliced off).
            sq1 = jnp.ones((1, n), jnp.int32)
            if pad:
                sq1 = sq1.at[:, n_real:].set(0)
            st = fresh_state(
                n,
                pixel=padded_pixels(y0, n_real, pad),
                s_base=(jnp.arange(n, dtype=jnp.int32) % kpp)[None],
                s_quota=sq1,
            )
            st = p_respawn_step(cam_x, st, salt, jnp.int32(0),
                                make_dims(cfg, w, h, spp, kpp), cfg=scfg,
                                n_frames=n_frames)
            do_steps = make_steps(salt, kpp)
            st, _ = do_steps(st, cfg.max_depth + 1, 0)
            est = jnp.sum(st.depth[0, :n_real].reshape(take * w, kpp),
                          axis=1)
            if cfg.adaptive_pool == "on":
                est = _pool_est(est, take, w)
            accum = accum.at[:, st.pixel[0] // kpp].add(st.radiance_sum)

            # Phase 2: remaining samples on difficulty-proportional
            # lanes (same lane budget incl. the filler lanes — the
            # allocator fills ALL n lanes with real work, raw-pixel-id
            # encoding).
            pix2, s_base2, s_quota2 = alloc_lanes(
                est, n_lanes=n, spp_done=kpp, spp=spp,
                kpp_max=cfg.kpp_max)
            salt2 = np.uint32((int(salt) * 0x85EBCA77 + 0x632BE5AB)
                              & 0xFFFFFFFF)
            st = fresh_state(n, pixel=pix2 + y0 * w, s_base=s_base2,
                             s_quota=s_quota2)
            st = p_respawn_step(cam_x, st, salt2, jnp.int32(0),
                                make_dims(cfg, w, h, spp, 1), cfg=scfg,
                                n_frames=n_frames)
            spp_rest = spp - kpp
            st, accum = run_loop(
                st, accum, make_steps(salt2, 1), kpp_s=1,
                first_check=spp_rest // min(cfg.kpp_max, spp_rest) + 2,
                max_steps=(spp_rest + 1) * (cfg.max_depth + 2),
                state_sorted=(bin_box is None
                              and h_virt * w * kpp < _SORT_PIX_LIM),
                finish=(make_finish(salt2, 1)
                        if one_shot == "on" else None),
                staged_fn=(make_staged(salt2, 1)
                           if one_shot == "staged" else None))
            flush_div = 1
        else:
            sq = jnp.full((1, n), quota, jnp.int32)
            if pad:
                sq = sq.at[:, n_real:].set(0)
            st = fresh_state(
                n,
                pixel=padded_pixels(y0, n_real, pad),
                s_base=(jnp.arange(n, dtype=jnp.int32) % kpp * quota)[None],
                s_quota=sq,
            )
            st = p_respawn_step(cam_x, st, salt, jnp.int32(0),
                                make_dims(cfg, w, h, spp, kpp), cfg=scfg,
                                n_frames=n_frames)
            # One-shot regime: at/below the compaction floor the host
            # loop only ever decides termination, so the whole chunk
            # runs as one device-side while_loop.  Above the floor the
            # host loop runs with the one-shot TAIL finisher instead
            # (compaction still happens where it pays).
            if one_shot == "staged" and n <= _COMPACT_FLOOR:
                st, accum = make_staged(salt, kpp)(st, accum, 0, max_steps)
            elif one_shot in ("on", "chunk") and n <= _COMPACT_FLOOR:
                st = p_render_oneshot(
                    scene, cam_x, st, salt, jnp.int32(0),
                    make_dims(cfg, w, h, spp, kpp), jnp.int32(max_steps),
                    cfg=scfg, hit_fn=hit_fn, n_frames=n_frames,
                    lean=lean)
            else:
                # Pixel order starts as identity; receiver
                # redistribution and ray binning break it (and with it
                # the argsort-free tail flush).
                st, accum = run_loop(
                    st, accum, make_steps(salt, kpp), kpp_s=kpp,
                    first_check=first_check, max_steps=max_steps,
                    state_sorted=(bin_box is None
                                  and h_virt * w * kpp < _SORT_PIX_LIM),
                    finish=(make_finish(salt, kpp)
                            if one_shot == "on" else None),
                    staged_fn=(make_staged(salt, kpp)
                               if one_shot == "staged" else None))
            flush_div = kpp
        # Flush this chunk's remaining radiance into the accumulator.
        accum = accum.at[:, st.pixel[0] // flush_div].add(st.radiance_sum)
        if chunk_callback is not None:
            chunk_callback(accum, y0 + take)

    out = (accum / spp).T.reshape(h_virt, w, 3)
    if cams is not None:
        return out.reshape(n_frames, h, w, 3)
    return out
