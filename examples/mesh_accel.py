"""Render a triangle mesh through the acceleration stack.

The reference has no mesh path at all (win32-raytracer RayTracer.cpp
sweeps spheres only); this framework adds triangle scenes with a
Morton/median-tiled grid (tri_accel.py), occlusion-capped working-set
re-binning, and DDA macro-cell expansion (kernels/tri_rebin.py /
tri_dda.py).  This example renders the bunny-class icosphere scene at
each tri_rebin mode through the grid sweep (accel='grid') and reports
timings.

Usage: python examples/mesh_accel.py [width height spp]
"""

import sys
import time

from _common import maybe_force_cpu

maybe_force_cpu()

import numpy as np

import win32_raytracer_tpu as wrt
from win32_raytracer_tpu.scene.builders import mesh_scene

args = [int(x) for x in sys.argv[1:4]]
w, h, spp = args + [160, 120, 8][len(args):]

scene = mesh_scene(subdivisions=3)  # ~1.3k triangles (5 => ~20k)
base = wrt.RenderConfig(width=w, height=h, samples=spp, seed=3,
                        accel="grid")

imgs = {}
for mode in ("off", "on", "dda"):
    cfg = base.replace(tri_rebin=mode, ray_binning="off")
    t0 = time.perf_counter()
    res = wrt.render(scene, cfg=cfg)
    dt = time.perf_counter() - t0
    imgs[mode] = np.asarray(res.image)
    print(f"tri_rebin={mode:>3s}: {dt:6.2f}s "
          f"({res.mrays_per_sec:.2f} Mrays/s primary)")

# 'on' never permutes state lanes -> identical image up to the
# cross-tile tie rule and rounding in differently fused programs, so
# tolerate isolated pixel flips instead of asserting bitwise equality.
mismatch = (imgs["on"] != imgs["off"]).any(axis=-1).mean()
assert mismatch <= 1e-3, (
    f"rebin should match the plain sweep (cross-tile ties aside); "
    f"{mismatch * 100:.3f}% of pixels differ")
if mismatch:
    print(f"rebin vs off: {mismatch * 100:.4f}% pixels differ "
          "(cross-tile equal-t ties)")
diff = np.abs(imgs["dda"].astype(np.int16) - imgs["off"].astype(np.int16))
print(f"dda vs off: max pixel delta {diff.max()} (u8), "
      f"{(diff > 1).mean() * 100:.2f}% pixels differ by >1")

wrt.write_image("mesh.png", imgs["dda"])
print("wrote mesh.png")
