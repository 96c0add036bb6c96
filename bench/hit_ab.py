#!/usr/bin/env python
"""Sphere-hit kernel vs the plain XLA sweep on one GPU.

    python bench/hit_ab.py [--reps 5]

1. Kernel time: the Triton kernel (kernels/hit_triton.py) at several
   (block, num_warps) pairs, and the plain sweep (ops/hit.py), at the
   final scene's full chunk (4,194,304 lanes x 512 spheres) and at the
   400x200 test scene's width (320,000 lanes x 128 spheres).  Mean of 20
   back-to-back calls after a warm-up, wall clock to block_until_ready.
2. End to end: api.render of BASELINE config 2 (RTIOW final scene,
   1200x800 @ 100 spp), warm, backend "pallas" vs "jnp", in turns
   (pallas, jnp, jnp, pallas, ...), ``--reps`` pairs.

Prints the card (nvidia-smi name and power limit) and the JAX device
first, then one line per measurement and a JSON summary last.  Fails
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def kernel_times(scene, cam, n, configs):
    import jax
    from win32_raytracer_tpu.kernels.hit_triton import hit_spheres_triton
    from win32_raytracer_tpu.ops.hit import hit_spheres
    from win32_raytracer_tpu.ops.rows import hit_rows_adapter

    o, d, tm = chip_smoke.kernel_rays(cam, n)
    fns = {"xla": jax.jit(lambda o, d, t: hit_rows_adapter(hit_spheres)(
        scene, o, d, t))}
    for blk, nw in configs:
        fns[f"kernel b{blk} w{nw}"] = jax.jit(
            lambda o, d, t, blk=blk, nw=nw: hit_spheres_triton(
                scene, o, d, t, block=blk, num_warps=nw))
    out = {}
    for name, fn in fns.items():
        jax.block_until_ready(fn(o, d, tm))
        t0 = time.perf_counter()
        for _ in range(20):
            r = fn(o, d, tm)
        jax.block_until_ready(r)
        out[name] = (time.perf_counter() - t0) / 20 * 1e3
        print(f"  {name}: {out[name]:.3f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from win32_raytracer_tpu._cache import enable_compile_cache
    from win32_raytracer_tpu.utils.device import nvidia_smi, require_gpu

    print(nvidia_smi(), flush=True)
    enable_compile_cache()
    platform, kind, count = require_gpu(1)
    print(f"jax: platform={platform} kind={kind} count={count}", flush=True)

    from win32_raytracer_tpu import api
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.scene.builders import get_scene
    from win32_raytracer_tpu.scene.camera import default_camera

    configs = [(128, 4), (256, 2), (256, 4), (512, 2), (512, 4),
               (512, 8), (1024, 4), (1024, 8)]
    summary = {"device": {"platform": platform, "kind": kind,
                          "count": count}}
    print("kernel, final scene, 4194304 lanes x 512 spheres:", flush=True)
    summary["final_ms"] = kernel_times(get_scene("final"),
                                       default_camera(1200, 800), 1 << 22,
                                       configs)
    print("kernel, test scene, 320000 lanes x 128 spheres:", flush=True)
    summary["test_ms"] = kernel_times(get_scene("test"),
                                      default_camera(400, 200), 320000,
                                      configs)

    cfg = RenderConfig(width=1200, height=800, samples=100, seed=3)
    walls = {"pallas": [], "jnp": []}
    for backend in walls:
        api.render("final", cfg=cfg.replace(backend=backend))   # compile
    order = ["pallas", "jnp"]
    for rep in range(args.reps):
        for backend in (order if rep % 2 == 0 else order[::-1]):
            res = api.render("final", cfg=cfg.replace(backend=backend,
                                                      seed=3 + rep))
            walls[backend].append(res.duration_ms / 1e3)
            print(f"  config 2 {backend} rep {rep}: "
                  f"{walls[backend][-1]:.4f} s", flush=True)
    summary["config2_wall_s"] = {
        b: {"median": statistics.median(w), "all": w}
        for b, w in walls.items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
