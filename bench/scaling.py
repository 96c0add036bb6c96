#!/usr/bin/env python
"""Device-scaling sweep — the manualTestResults.txt analogue.

The reference hand-recorded a thread-count sweep at 640x480 @ 50 spp
(/root/reference/manualTestResults.txt); this sweeps mesh device counts for
both sharding modes and prints one JSON line per point.

Every line names the device it ran on.  With --platform cpu it sweeps a
virtual CPU mesh (functional scaling only, no device timing); on a
multi-GPU host it measures real scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), '..')))
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="640x480x50",
                    help="WxHxSPP (reference sweep unit)")
    ap.add_argument("--scene", default="random")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--mode", default="rows", choices=["rows", "spp", "persistent"])
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax

    from win32_raytracer_tpu._cache import enable_compile_cache

    enable_compile_cache()

    from win32_raytracer_tpu.api import render
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.parallel.shard import make_mesh

    w, h, s = (int(v) for v in args.config.split("x"))
    cfg = RenderConfig(width=w, height=h, samples=s, seed=3)
    avail = len(jax.devices())
    dev = {"platform": jax.devices()[0].platform,
           "kind": jax.devices()[0].device_kind}
    rays = w * h * s

    for d in (int(v) for v in args.devices.split(",")):
        if d > avail:
            print(json.dumps({"devices": d, "skipped": f"only {avail} available"}))
            continue
        mesh = make_mesh(d) if d > 1 else None
        res = render(args.scene, cfg=cfg, mesh=mesh, shard_mode=args.mode)  # warm
        t0 = time.perf_counter()
        res = render(args.scene, cfg=cfg, mesh=mesh, shard_mode=args.mode)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "devices": d, "device": dev,
            "mode": args.mode if d > 1 else "single",
            "wall_ms": round(dt * 1e3, 1),
            "mrays_per_sec": round(rays / dt / 1e6, 3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
