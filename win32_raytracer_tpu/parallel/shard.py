"""Tile parallelism over a device mesh (SPMD via shard_map).

The reference scales with std::threads over interleaved 8-row image blocks
(win32-raytracer/RayTracer.cpp:971-999, rationale comment at 973-978: all
threads work the same region of the image so no thread is left grinding the
complex bottom rows alone).  Here the same two axes become mesh axes:

* **row sharding** (default): each chip owns interleaved row blocks — block
  b of a superchunk goes to device b, the exact analogue of the reference's
  stride-N*8 assignment.  No collectives; assembly is just sharded output
  (the `res.imageParts` stitch of Game.cpp:94-102 becomes array layout).
* **spp sharding**: every chip renders the full chunk at samples/D with
  decorrelated keys; per-pixel sample means are combined with a
  ``jax.lax.pmean`` over the mesh — the cross-device all-reduce replacing
  the shared-memory join (RayTracer.cpp:1001-1004).

Implementation notes:

* Each wavefront step (primary rays / hit / scatter / accumulate) is
  shard-mapped *separately* and driven from Python, exactly like the
  single-device path.
* Per-device draws key on each device's start row (a sharded input), so
  a render is reproducible for a given mesh size.
* The hit function follows ``cfg.backend`` on the mesh devices' platform
  (kernels/dispatch.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..render import (
    HitFn,
    WavefrontState,
    accumulate_pixels,
    hit_step,
    make_primary_rays,
    scatter_step,
    tonemap,
)
from ..scene.camera import Camera, default_camera
from ..scene.spheres import SphereScene


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (all by default)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("tiles",))


def _state_spec():
    return WavefrontState(*(P("tiles") for _ in WavefrontState._fields))


@functools.lru_cache(maxsize=64)
def _shard_steps(mesh: Mesh, cfg: RenderConfig, width: int, height: int,
                 spp: int, rows: int, hit_fn: HitFn):
    """Build the shard-mapped step functions for one chunk geometry.

    Cached: the returned jitted closures must be reused across render calls
    (animation frames!) or every call would retrace and recompile."""
    sspec = _state_spec()

    def primary(cam, y0s, dev_keys):
        # y0s: [D] global start row per device; dev_keys: [D, 2] fold keys.
        return make_primary_rays(
            cam, y0s[0], dev_keys[0],
            cfg=cfg, width=width, height=height, spp=spp, rows=rows,
        )

    primary_sm = jax.jit(jax.shard_map(
        primary, mesh=mesh,
        in_specs=(P(), P("tiles"), P("tiles")),
        out_specs=sspec,
    ))

    def hit_sm_fn(scene, state):
        return hit_step(scene, state, cfg=cfg, hit_fn=hit_fn)

    # HitRecord is a NamedTuple of [N]-leading arrays -> all P("tiles").
    from ..ops.hit import HitRecord
    hspec = HitRecord(*(P("tiles") for _ in HitRecord._fields))

    # check_vma=False: hit_fn may be a pallas kernel, whose
    # ShapeDtypeStruct outputs carry no varying-mesh-axes annotation.
    hit_sm = jax.jit(jax.shard_map(
        hit_sm_fn, mesh=mesh,
        in_specs=(P(), sspec),
        out_specs=(hspec, sspec), check_vma=False,
    ))

    def scat_fn(scene, state, rec, keys, depth):
        return scatter_step(scene, state, rec, keys[0], depth, cfg=cfg)

    scat_sm = jax.jit(jax.shard_map(
        scat_fn, mesh=mesh,
        in_specs=(P(), sspec, hspec, P("tiles"), P()),
        out_specs=sspec,
    ), static_argnames=())

    def accum_rows(radiance):
        return accumulate_pixels(radiance, width=width, spp=spp, rows=rows)

    accum_rows_sm = jax.jit(jax.shard_map(
        accum_rows, mesh=mesh, in_specs=P("tiles"), out_specs=P("tiles"),
    ))

    def accum_spp(radiance):
        local = accumulate_pixels(radiance, width=width, spp=spp, rows=rows)
        return jax.lax.pmean(local, "tiles")  # all-reduce of sample means

    accum_spp_sm = jax.jit(jax.shard_map(
        accum_spp, mesh=mesh, in_specs=P("tiles"), out_specs=P(),
    ))

    return primary_sm, hit_sm, scat_sm, accum_rows_sm, accum_spp_sm


def render_image_sharded(
    scene: SphereScene,
    cam: Optional[Camera],
    cfg: RenderConfig,
    mesh: Mesh,
    mode: str = "rows",
    hit_fn: Optional[HitFn] = None,
) -> jnp.ndarray:
    """Render the full image over the mesh; returns linear [H, W, 3] f32.

    mode="rows": image rows interleaved across devices (reference-style
    load balancing); mode="spp": sample-sharded with a pmean.
    """
    if mode == "persistent":
        # The production scheduler, sharded: lane-local steps shard-mapped
        # over the mesh with interleaved row-block ownership.  NOTE: a
        # caller-supplied hit_fn must use the rows interface
        # (ops/rows.py), unlike the column-layout hit_fn of rows/spp mode.
        from .persistent_shard import render_image_persistent_sharded
        return render_image_persistent_sharded(scene, cam, cfg, mesh,
                                               hit_fn=hit_fn)
    if hit_fn is None:
        from ..kernels.dispatch import get_hit_fn
        hit_fn = get_hit_fn(cfg, scene,
                            platform=mesh.devices.flat[0].platform)
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    w, h, spp = cfg.width, cfg.height, cfg.samples
    d = mesh.devices.size
    key = jax.random.PRNGKey(cfg.seed)
    cfg = cfg.replace(seed=0)  # steps must not recompile per seed

    if mode == "spp":
        if spp % d:
            raise ValueError(f"spp mode needs samples % devices == 0 "
                             f"({spp} % {d})")
        spp_local = spp // d
        rows = max(1, min(h, cfg.rays_per_chunk // max(1, w * spp_local)))
        steps = _shard_steps(mesh, cfg, w, h, spp_local, rows, hit_fn)
        primary_sm, hit_sm, scat_sm, _, accum_spp_sm = steps
        out = []
        dev_ids = np.arange(d, dtype=np.int64)
        for y0 in range(0, h, rows):
            # Same rows everywhere; decorrelated per-device sample keys.
            y0s = jnp.full((d,), y0, jnp.int32)
            base = jax.random.fold_in(key, y0)
            cam_keys = jnp.stack(
                [jax.random.fold_in(jax.random.fold_in(base, 1), int(i))
                 for i in dev_ids])
            trc_keys = jnp.stack(
                [jax.random.fold_in(jax.random.fold_in(base, 2), int(i))
                 for i in dev_ids])
            state = primary_sm(cam, y0s, cam_keys)
            for depth in range(cfg.max_depth + 1):
                rec, state = hit_sm(scene, state)
                state = scat_sm(scene, state, rec, trc_keys,
                                jnp.int32(depth))
            block = accum_spp_sm(state.radiance)
            take = min(rows, h - y0)
            out.append(block[:take])
        return jnp.concatenate(out, axis=0)

    if mode != "rows":
        raise ValueError(f"unknown mode {mode!r} (rows|spp|persistent)")

    # Row mode: superchunks of D interleaved row-blocks, one per device.
    rows = max(1, min(-(-h // d), cfg.rays_per_chunk // max(1, w * spp)))
    steps = _shard_steps(mesh, cfg, w, h, spp, rows, hit_fn)
    primary_sm, hit_sm, scat_sm, accum_rows_sm, _ = steps

    blocks_per_super = d
    super_rows = rows * blocks_per_super
    n_super = -(-h // super_rows)

    parts = []   # superchunk blocks, consecutive rows
    for s_i in range(n_super):
        y0s_np = np.array(
            [s_i * super_rows + b * rows for b in range(d)], np.int32)
        y0s = jnp.asarray(y0s_np)
        base = jax.random.fold_in(key, int(y0s_np[0]))
        cam_keys = jnp.stack(
            [jax.random.fold_in(jax.random.fold_in(base, 1), int(y))
             for y in y0s_np])
        trc_keys = jnp.stack(
            [jax.random.fold_in(jax.random.fold_in(base, 2), int(y))
             for y in y0s_np])
        state = primary_sm(cam, y0s, cam_keys)
        for depth in range(cfg.max_depth + 1):
            rec, state = hit_sm(scene, state)
            state = scat_sm(scene, state, rec, trc_keys, jnp.int32(depth))
        blocks = accum_rows_sm(state.radiance)  # [D*rows, W, 3] row-sharded
        parts.append(blocks)

    # Assemble: device b's rows inside superchunk s sit at global rows
    # [s*super_rows + b*rows, +rows) — exactly the order the sharded output
    # already has, so the imageParts stitch (Game.cpp:94-102 analogue) is a
    # plain concatenation.
    return jnp.concatenate(parts, axis=0)[:h]


def render_sharded(
    scene: SphereScene,
    cam: Optional[Camera] = None,
    cfg: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    mode: str = "rows",
    hit_fn: Optional[HitFn] = None,
) -> np.ndarray:
    """Multi-device render to u8 [H, W, 3]."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    linear = render_image_sharded(scene, cam, cfg, mesh, mode=mode,
                                  hit_fn=hit_fn)
    return np.asarray(tonemap(linear))
