"""Wavefront renderer core (single device).

The reference's recursive ``getColor`` (win32-raytracer/RayTracer.cpp:392-704,
depth-limited to MAX_RECURSION=10) becomes an iterative wavefront over a
whole ``[N]`` ray batch carrying ``(origin, direction, time, throughput,
radiance, alive)`` — SURVEY.md §7's formulation.  Termination semantics are
preserved exactly:

* miss at depth <= max_depth -> sky gradient scaled by throughput
  (RayTracer.cpp:690-701);
* metal absorb -> black (RayTracer.cpp:625-628);
* still alive after depth max_depth -> black (``recurseDepth >
  MAX_RECURSION`` check, RayTracer.cpp:399-402) — i.e. max_depth+1 scatter
  events are allowed, matching the reference's ``++recurseDepth`` chain.

The bounce loop is a Python loop over small jitted steps: the wavefront
state stays on device between dispatches, dispatches are pipelined (no host
sync until the final image fetch), and every compiled program stays small.

The per-tile pixel loop (``generateImage``, RayTracer.cpp:894-959) becomes
:func:`render_image`: pixel/sample lanes are flattened to ``[rows*W*spp]``
chunks, jitter/camera draws come from counter-based keys, and the final
mean -> sqrt-gamma -> u8 conversion matches RayTracer.cpp:946-954.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .config import RenderConfig
from .core.materials import sky_color
from .core.rng import uniform01
from .ops.hit import hit_spheres
from .ops.scatter import scatter
from .scene.camera import Camera, camera_rays, default_camera
from .scene.spheres import SphereScene

HitFn = Callable[..., object]


class WavefrontState(NamedTuple):
    """Per-lane path state carried across bounces (device-resident)."""

    origin: jnp.ndarray      # [N, 3]
    direction: jnp.ndarray   # [N, 3]
    time: jnp.ndarray        # [N]
    throughput: jnp.ndarray  # [N, 3]
    radiance: jnp.ndarray    # [N, 3]
    alive: jnp.ndarray       # [N] bool


@functools.partial(
    jax.jit, static_argnames=("cfg", "width", "height", "spp", "rows")
)
def make_primary_rays(
    cam: Camera,
    y0: jnp.ndarray,
    key: jax.Array,
    *,
    cfg: RenderConfig,
    width: int,
    height: int,
    spp: int,
    rows: int,
) -> WavefrontState:
    """Camera rays for ``rows`` image rows starting at global row ``y0``.

    Jitter and mapping match ``generateImage`` (RayTracer.cpp:934-944):
    ``u=(x+r0)/W``, ``v=(H-y+r1)/H`` — note the reference's y-flip uses
    ``H-y``, not ``H-1-y``.
    """
    n = rows * width * spp
    lane = jnp.arange(n, dtype=jnp.int32)
    y = y0 + lane // (width * spp)
    x = (lane // spp) % width

    if cfg.deterministic:
        draws = jnp.full((n, 5), 0.5, jnp.float32)
        draws = draws.at[:, 2].set(0.0)  # shutter-open time
    else:
        draws = uniform01(jax.random.fold_in(key, 0), (n, 5))

    u = (x.astype(jnp.float32) + draws[:, 0]) / width
    v = ((height - y).astype(jnp.float32) + draws[:, 1]) / height
    o, d, tm = camera_rays(cam, u, v, draws[:, 2:5])
    return WavefrontState(
        origin=o,
        direction=d,
        time=tm,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "hit_fn"))
def hit_step(
    scene: SphereScene,
    state: WavefrontState,
    *,
    cfg: RenderConfig,
    hit_fn: HitFn = hit_spheres,
):
    """Bounce part 1: nearest-hit sweep + miss->sky radiance.

    Split from :func:`scatter_step` so each program stays small.
    """
    rec = hit_fn(scene, state.origin, state.direction, state.time,
                 min_t=cfg.min_hit_t)
    # Miss -> sky, weighted by current throughput (RayTracer.cpp:690-701).
    miss = state.alive & ~rec.hit
    rad = state.radiance + jnp.where(
        miss[:, None], state.throughput * sky_color(state.direction), 0.0)
    return rec, state._replace(radiance=rad)


@functools.partial(jax.jit, static_argnames=("cfg",))
def scatter_step(
    scene: SphereScene,
    state: WavefrontState,
    rec,
    key: jax.Array,
    depth: jnp.ndarray,
    *,
    cfg: RenderConfig,
) -> WavefrontState:
    """Bounce part 2: material scatter + masked state update (+ optional RR)."""
    o, d, tm, thr, rad, alive = state
    n = o.shape[0]
    if cfg.deterministic:
        draws = jnp.full((n, 5), 0.5, jnp.float32)
    else:
        draws = uniform01(jax.random.fold_in(key, depth), (n, 5))
    sc = scatter(scene, d, rec, draws, cfg)

    live_hit = alive & rec.hit
    thr = jnp.where(live_hit[:, None], thr * sc.attenuation, thr)
    o = jnp.where(live_hit[:, None], sc.origin, o)
    d = jnp.where(live_hit[:, None], sc.direction, d)
    alive = live_hit & sc.alive

    if cfg.russian_roulette:
        p = jnp.clip(jnp.max(thr, axis=-1), 0.05, 1.0)
        rr_on = alive & (depth >= cfg.rr_start_depth)
        survive = draws[:, 4] < p
        thr = jnp.where(rr_on[:, None], thr / p[:, None], thr)
        alive = alive & jnp.where(rr_on, survive, True)

    return WavefrontState(o, d, tm, thr, rad, alive)


def bounce_step(
    scene: SphereScene,
    state: WavefrontState,
    key: jax.Array,
    depth: jnp.ndarray,
    *,
    cfg: RenderConfig,
    hit_fn: HitFn = hit_spheres,
) -> WavefrontState:
    """One scatter event for the whole wavefront (two pipelined dispatches)."""
    rec, state = hit_step(scene, state, cfg=cfg, hit_fn=hit_fn)
    return scatter_step(scene, state, rec, key, depth, cfg=cfg)


@functools.partial(jax.jit, static_argnames=("width", "spp", "rows"))
def accumulate_pixels(
    radiance: jnp.ndarray, *, width: int, spp: int, rows: int
) -> jnp.ndarray:
    """Mean over samples -> linear per-pixel radiance [rows, W, 3]."""
    return radiance.reshape(rows, width, spp, 3).mean(axis=2)


def trace(
    scene: SphereScene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    time: jnp.ndarray,
    key: jax.Array,
    cfg: RenderConfig,
    hit_fn: HitFn = hit_spheres,
) -> jnp.ndarray:
    """Trace [N] rays to completion; returns linear radiance [N, 3]."""
    n = origin.shape[0]
    state = WavefrontState(
        origin=origin,
        direction=direction,
        time=time,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
    )
    # max_depth+1 scatter events (depths 0..max_depth); survivors are black.
    for depth in range(cfg.max_depth + 1):
        state = bounce_step(scene, state, key, jnp.int32(depth),
                            cfg=cfg, hit_fn=hit_fn)
    return state.radiance


def render_image(
    scene: SphereScene,
    cam: Optional[Camera],
    cfg: RenderConfig,
    hit_fn: HitFn = hit_spheres,
    progress=None,
) -> jnp.ndarray:
    """Render the full image; returns linear radiance [H, W, 3] f32.

    Rows are processed in fixed-size chunks (bounding wavefront memory); the
    per-chunk RNG key is folded with the chunk's global start row so the
    image is deterministic for a given (seed, chunk size).  All chunk/bounce
    dispatches are pipelined; the only host syncs are the final fetches.
    """
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    w, h, spp = cfg.width, cfg.height, cfg.samples
    rows = max(1, min(h, cfg.rays_per_chunk // max(1, w * spp)))
    key = jax.random.PRNGKey(cfg.seed)
    # The seed only feeds the (host-side) key; zero it in the cfg handed to
    # the jitted steps so different seeds share one compiled program.
    cfg = cfg.replace(seed=0)

    from .utils.progress import ProgressTracker
    tracker = ProgressTracker(h, w * spp, progress)

    out = []
    for y0 in range(0, h, rows):
        ckey = jax.random.fold_in(key, y0)
        state = make_primary_rays(
            cam, jnp.int32(y0), jax.random.fold_in(ckey, 1),
            cfg=cfg, width=w, height=h, spp=spp, rows=rows,
        )
        tkey = jax.random.fold_in(ckey, 2)
        for depth in range(cfg.max_depth + 1):
            state = bounce_step(scene, state, tkey, jnp.int32(depth),
                                cfg=cfg, hit_fn=hit_fn)
        block = accumulate_pixels(state.radiance, width=w, spp=spp, rows=rows)
        take = min(rows, h - y0)
        out.append(block[:take] if take < rows else block)
        tracker.chunk_done(take)
    tracker.done()
    return jnp.concatenate(out, axis=0)


def tonemap(linear: jnp.ndarray) -> jnp.ndarray:
    """Gamma-2 + u8 quantization (RayTracer.cpp:948-954)."""
    c = jnp.sqrt(jnp.maximum(linear, 0.0))
    return jnp.clip(jnp.floor(255.99 * c), 0.0, 255.0).astype(jnp.uint8)


def render(
    scene: SphereScene,
    cam: Optional[Camera] = None,
    cfg: Optional[RenderConfig] = None,
    hit_fn: Optional[HitFn] = None,
) -> np.ndarray:
    """Render to a u8 [H, W, 3] image (top row first, like the reference).

    The hit backend follows ``cfg.backend`` (the Triton kernel on a GPU,
    the plain sweep on the CPU) unless ``hit_fn`` is given explicitly.
    """
    cfg = cfg or RenderConfig()
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    from .config import resolve_scheduler
    scheduler = resolve_scheduler(cfg)
    if scheduler == "persistent":
        # The persistent scheduler runs lane-major (ops/rows.py); an
        # explicitly-passed column hit_fn is adapted, otherwise the rows
        # dispatcher picks the native rows kernel.
        from .persistent import render_image_persistent
        rows_hit = None
        if hit_fn is not None:
            from .ops.rows import hit_rows_adapter
            rows_hit = hit_rows_adapter(hit_fn)
        linear = render_image_persistent(scene, cam, cfg, hit_fn=rows_hit)
    elif scheduler == "wavefront":
        if hit_fn is None:
            from .kernels.dispatch import get_hit_fn
            hit_fn = get_hit_fn(cfg, scene)
        linear = render_image(scene, cam, cfg, hit_fn=hit_fn)
    else:
        raise ValueError(
            f"unknown scheduler {cfg.scheduler!r} (auto|wavefront|persistent)")
    return np.asarray(tonemap(linear))
