#!/usr/bin/env python
"""Benchmark: RTIOW final scene, 1200x800 @ 100 spp on one GPU.

Prints the device on stderr (nvidia-smi's name and power limit; JAX's
platform, kind and count) and ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
Fails without a GPU.

Baseline: the reference's best multi-threaded AVX CPU figure — 2.50 Mrays/s
primary (640x480x50spp in 6143 ms at 20 threads on an i5-2500K;
BASELINE.md, derived from /root/reference/manualTestResults.txt:16).
"rays" counts primary rays only (W*H*spp), matching BASELINE.md's
conservative convention.

Protocol: one warm-up render compiles every program (reported as
warmup_s), then three timed renders with distinct seeds, wall clock to a
fetched u8 image; the best is reported.
"""

import json
import sys
import time

BASELINE_MRAYS = 2.50

WIDTH, HEIGHT, SPP = 1200, 800, 100


def main():
    from win32_raytracer_tpu._cache import enable_compile_cache
    from win32_raytracer_tpu.utils.device import nvidia_smi, require_gpu

    print(f"# {nvidia_smi()}", file=sys.stderr)
    enable_compile_cache()
    platform, kind, count = require_gpu(1)
    print(f"# jax: platform={platform} kind={kind} count={count}",
          file=sys.stderr)

    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.render import render
    from win32_raytracer_tpu.scene.builders import random_scene

    scene = random_scene()
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SPP, seed=3)

    t0 = time.perf_counter()
    img = render(scene, cfg=cfg.replace(seed=99))
    warm = time.perf_counter() - t0
    if not 1.0 <= float(img.mean()) <= 254.0:
        raise RuntimeError(f"suspicious warm-up image mean {img.mean():.2f}")
    print(f"# warm-up (incl. compiles): {warm:.2f}s", file=sys.stderr)

    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        img = render(scene, cfg=cfg.replace(seed=3 + rep))
        dt = time.perf_counter() - t0
        print(f"# timed[{rep}] seed={3 + rep}: {dt:.4f}s, image mean "
              f"{img.mean():.2f}", file=sys.stderr)
        best = min(best, dt)

    mrays = WIDTH * HEIGHT * SPP / best / 1e6
    print(json.dumps({
        "metric": "Mrays/sec primary, 1200x800@100spp RTIOW final scene, "
                  "1 GPU",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "wall_s": round(best, 4),
        "warmup_s": round(warm, 2),
        "device": {"platform": platform, "kind": kind, "count": count},
    }))


if __name__ == "__main__":
    main()
