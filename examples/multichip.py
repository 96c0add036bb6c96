"""Shard a render over a device mesh — the counterpart of the reference's
std::thread row scheduler (RayTracer.cpp:962-1010): interleaved row-
blocks per device, one cross-device reduction at the end.

On a multi-GPU host this uses the real GPUs.  With --cpu it demonstrates
the same code on a VIRTUAL 8-device CPU mesh (a one-GPU host WITHOUT
--cpu gets a 1-device mesh — the device-count override only affects the
CPU platform)."""

import os

# Set unconditionally, before jax initializes: it only affects the CPU
# platform (GPUs ignore it), and it must be in place for --cpu to
# see 8 virtual devices.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

from _common import maybe_force_cpu

maybe_force_cpu()

import jax
import numpy as np

import win32_raytracer_tpu as wrt
from win32_raytracer_tpu.parallel.shard import make_mesh, render_sharded

n = min(8, len(jax.devices()))
mesh = make_mesh(n)
print(f"mesh: {n} x {mesh.devices.flat[0].platform}")

scene = wrt.random_scene()
cfg = wrt.RenderConfig(width=320, height=240, samples=16, seed=3,
                       backend="auto")
res = render_sharded(scene, None, cfg, mesh, mode="persistent")
# mode="persistent" = the production scheduler sharded over interleaved
# row-blocks (the CLI's default shard mode); "rows"/"spp" shard the
# fixed-depth wavefront instead.
img = np.asarray(res)
wrt.write_image("sharded.png", img)
print(f"wrote sharded.png {img.shape}")
