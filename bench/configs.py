#!/usr/bin/env python
"""Run the BASELINE.json benchmark configs.

  1  3-sphere+ground test scene, 400x200 @ 16 spp, depth 8, CPU backend
  2  RTIOW final scene with defocus blur, 1200x800 @ 100 spp   (headline)
  3  high-spp wavefront: 4K @ 1000 spp, stratified + Russian roulette
  4  triangle-mesh scene (ray-triangle sweep; mesh demo or --obj FILE)
  5  tile-parallel animated flythrough (shard_map over every GPU)

Prints the device on stderr (nvidia-smi's name and power limit; JAX's
platform, kind and count) and one JSON line per config.  Fails without a
GPU.  --scale shrinks resolution/spp for smoke runs (e.g. --scale 0.1).
First-run compile cost is excluded by a warm-up render at the same shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), '..')))
import time


def run_config(idx: int, scale: float, obj: str = "",
               reps: int = 1, compact_quantum: int = 0):
    from win32_raytracer_tpu.api import render
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.scene.builders import get_scene

    def sc(v):
        return max(1, int(round(v * scale)))

    if idx == 1:
        cfg = RenderConfig(width=sc(400), height=sc(200), samples=sc(16),
                           max_depth=8, seed=3)
        scene, label = get_scene("test"), "test scene 400x200@16 d8"
    elif idx == 2:
        cfg = RenderConfig(width=sc(1200), height=sc(800), samples=sc(100),
                           seed=3)
        scene, label = get_scene("final"), "final scene 1200x800@100"
    elif idx == 3:
        cfg = RenderConfig(width=sc(3840), height=sc(2160), samples=sc(1000),
                           seed=3, stratify=True, russian_roulette=True,
                           scheduler="persistent",
                           compact_quantum=compact_quantum)
        scene, label = get_scene("final"), "4K@1000 stratified+RR"
    elif idx == 4:
        from win32_raytracer_tpu.scene.builders import mesh_scene
        if obj:
            from win32_raytracer_tpu.scene.composite import CompositeScene
            from win32_raytracer_tpu.scene.triangles import (
                build_triangle_scene, load_obj)
            v, f = load_obj(obj)
            scene = CompositeScene(
                spheres=get_scene("test"),
                triangles=build_triangle_scene(v, f))
            label = f"mesh {obj} ({len(f)} tris)"
        else:
            # Bunny-class mesh (BASELINE config 4 as written: >=10k tris).
            scene = mesh_scene(subdivisions=5)
            label = "mesh20k (20480-tri icosphere + box + spheres)"
        cfg = RenderConfig(width=sc(800), height=sc(450), samples=sc(50),
                           seed=3)
    elif idx == 5:
        from win32_raytracer_tpu.animation import orbit_path, render_animation
        from win32_raytracer_tpu.parallel.shard import make_mesh
        import jax
        n_dev = len(jax.devices())
        cfg = RenderConfig(width=sc(640), height=sc(480),
                           samples=max(n_dev, sc(32) // n_dev * n_dev),
                           seed=3)
        cams = orbit_path(n_frames=max(2, sc(8)),
                          aspect_ratio=cfg.width / cfg.height)
        scene = get_scene("final")
        mesh = make_mesh() if n_dev > 1 else None
        # Warm with the FULL camera list so every batch-group shape
        # compiles.  rows mode on a mesh frame-batches through the
        # sharded persistent driver (multi-frame virtual tall image,
        # row-blocks over devices).
        render_animation(scene, cams, cfg.replace(seed=cfg.seed + 7001),
                         mesh=mesh, shard_mode="rows")
        dt = float("inf")
        for rep in range(reps):
            t0 = time.perf_counter()
            frames = render_animation(scene, cams, cfg.replace(
                seed=cfg.seed + rep), mesh=mesh, shard_mode="rows")
            dt = min(dt, time.perf_counter() - t0)
        rays = cfg.width * cfg.height * cfg.samples * len(cams)
        return {
            "config": 5, "label": f"flythrough {len(cams)}f over {n_dev} dev",
            "value": round(rays / dt / 1e6, 3), "unit": "Mrays/s",
            "wall_s": round(dt, 2), "fps": round(len(frames) / dt, 3),
        }
    else:
        raise SystemExit(f"unknown config {idx}")

    # Warm on a shifted seed (same shapes, so all programs compile);
    # timed reps each use a distinct seed.  Best-of-N reported.
    render(scene, cfg=cfg.replace(seed=cfg.seed + 7001))
    dt = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        res = render(scene, cfg=cfg.replace(seed=cfg.seed + rep))
        dt = min(dt, time.perf_counter() - t0)
    rays = cfg.width * cfg.height * cfg.samples
    return {
        "config": idx, "label": label,
        "value": round(rays / dt / 1e6, 3), "unit": "Mrays/s",
        "wall_s": round(dt, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*", type=int, default=[1, 2, 4, 5],
                    help="config numbers to run (default 1 2 4 5; 3 is the "
                         "long 4K run)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--obj", default="", help="OBJ mesh for config 4")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed reps per config (best-of-N, distinct seeds)")
    ap.add_argument("--compact-quantum", type=int, default=0,
                    help="cfg.compact_quantum for config 3 (coarser "
                         "compaction ladder = fewer compiled step "
                         "programs; 0 = auto relative grid)")
    args = ap.parse_args()
    from win32_raytracer_tpu._cache import enable_compile_cache
    from win32_raytracer_tpu.utils.device import nvidia_smi, require_gpu

    print(f"# {nvidia_smi()}", file=sys.stderr)
    enable_compile_cache()
    platform, kind, count = require_gpu(1)
    print(f"# jax: platform={platform} kind={kind} count={count}",
          file=sys.stderr)
    for idx in (args.configs or [1, 2, 4, 5]):
        print(json.dumps(run_config(idx, args.scale,
                                    args.obj, reps=args.reps,
                                    compact_quantum=args.compact_quantum)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
