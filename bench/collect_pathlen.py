#!/usr/bin/env python
"""Collect the empirical per-(pixel, sample) path-length distribution of
the headline scene (RTIOW final scene, default camera, 1200x800).

Runs on CPU — path-length statistics are backend-independent — by driving
the wavefront bounce loop (render.py) band-by-band over a row subsample of
the image and recording, for every (pixel, sample) lane, how many scatter
events it consumed before dying (miss -> sky, metal absorb, or the
depth-10 cap; RayTracer.cpp:399-402 semantics).

Output: bench/pathlen_final.npz with
  lengths  [n_pixels, spp] uint8 — bounce steps consumed per sample
  ys, xs   [n_pixels] int32     — source pixel coordinates

The persistent scheduler's dead-lane integral is a pure function of these
lengths and the compaction policy, so scheduling policies can be replayed
offline against this data before they are measured on a GPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
from win32_raytracer_tpu._cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402

import numpy as np


WIDTH, HEIGHT = 1200, 800
SPP = 4            # samples per pixel collected (distribution, not image)
ROWS_PER_BAND = 12
BAND_STRIDE = 100  # bands at y0 = 0, 100, ... -> 96/800 rows sampled
SEED = 7


def main():
    import jax
    import jax.numpy as jnp

    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.render import bounce_step, make_primary_rays
    from win32_raytracer_tpu.scene.builders import random_scene
    from win32_raytracer_tpu.scene.camera import default_camera

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SPP)
    scene = random_scene()
    cam = default_camera(WIDTH, HEIGHT)
    key = jax.random.PRNGKey(SEED)

    all_len, all_y, all_x = [], [], []
    for y0 in range(0, HEIGHT, BAND_STRIDE):
        rows = min(ROWS_PER_BAND, HEIGHT - y0)
        st = make_primary_rays(cam, jnp.int32(y0), jax.random.fold_in(key, y0),
                               cfg=cfg, width=WIDTH, height=HEIGHT,
                               spp=SPP, rows=rows)
        n = rows * WIDTH * SPP
        # length = number of scatter events consumed: a sample dying at
        # depth d (alive drops False after scatter d) used d+1 steps; a
        # sample alive after depth max_depth is cut by the cap at
        # max_depth+1 steps (persistent.py's respawn kills it there).
        lengths = np.full(n, cfg.max_depth + 1, np.uint8)
        alive_prev = np.ones(n, bool)
        for depth in range(cfg.max_depth + 1):
            st = bounce_step(scene, st, jax.random.fold_in(key, 1000 + y0),
                             jnp.int32(depth), cfg=cfg)
            alive = np.asarray(st.alive)
            died = alive_prev & ~alive
            lengths[died] = depth + 1
            alive_prev = alive
        lane = np.arange(n)
        y = y0 + lane // (WIDTH * SPP)
        x = (lane // SPP) % WIDTH
        all_len.append(lengths.reshape(-1, SPP))
        all_y.append(y.reshape(-1, SPP)[:, 0].astype(np.int32))
        all_x.append(x.reshape(-1, SPP)[:, 0].astype(np.int32))
        print(f"band y0={y0}: mean len "
              f"{lengths.mean():.3f}, cap frac "
              f"{(lengths == cfg.max_depth + 1).mean():.4f}", flush=True)

    lengths = np.concatenate(all_len)
    ys = np.concatenate(all_y)
    xs = np.concatenate(all_x)
    out = os.path.join(os.path.dirname(__file__), "pathlen_final.npz")
    np.savez_compressed(out, lengths=lengths, ys=ys, xs=xs)
    print(f"saved {out}: {lengths.shape[0]} pixels x {SPP} spp, "
          f"mean {lengths.mean():.4f}, p99 "
          f"{np.percentile(lengths, 99):.0f}")


if __name__ == "__main__":
    sys.exit(main())
