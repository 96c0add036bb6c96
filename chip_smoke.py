#!/usr/bin/env python
"""Smoke test of the renderer's main path on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

One GPU, in order:

1. device   -- nvidia-smi's name and power limit; JAX's platform, kind and
               count.  Anything but a GPU is refused (exit 1, no result).
2. gpu tests -- ``pytest -m gpu`` in a child process, which exits before
               this process first touches JAX (one process per card).
3. kernel   -- the Triton sphere kernel (kernels/hit_triton.py) against the
               plain XLA sweep (ops/hit.py, f32, no matrix units) at the
               main path's width (4,194,304 lanes x the final scene's
               512-sphere table) and at the 400x200 test scene's width.
4. memory   -- ``compiled.memory_analysis()`` of the two bounce programs
               (hit; scatter+respawn) at that width.
5. config 2 -- RTIOW final scene, 1200x800 @ 100 spp, through api.render
               and through the CLI's main() in this process; both images
               and the plain-XLA render of the same seed must agree.
6. config 4 -- mesh20k (20,480 triangles), 800x450 @ 50 spp.
7. golden   -- the deterministic golden cases of tests/test_golden.py
               against the native C++ oracle.

Four GPUs (``--four``): the sharded stills (parallel.shard modes rows, spp,
persistent) and the sharded flythrough (BASELINE config 5), each against
the same render on one card in this process.

No phase catches another's failure: any exception ends the run with a
non-zero exit.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernel comparison (phase 3).  Both sides evaluate the
# same float32 expression sequence per ray-sphere pair, so they can differ
# only by rounding: FMA contraction and the division / square-root
# lowering of the two compilers, a few ulps (one f32 ulp is 1.2e-7
# relative).  Hence t within REL_T relative.  Two cases are exempt, judged
# in float64 on the host: a winner that differs where the two candidates'
# t are within TIE_REL (a near-tie that rounding may break either way),
# and a lane tangent to the sphere in question (|disc| <= TANGENT_REL *
# b^2), where rounding flips the hit flag and sqrt(disc) amplifies it.
REL_T = 1e-6
TIE_REL = 1e-6
TANGENT_REL = 1e-6
PLAIN_PIXELS = 1e-3

# Sharded renders use other random streams than one card (the per-lane
# draws key on device and lane position), so they agree statistically:
# the mean absolute difference of the tonemapped u8 images stays within
# the Monte-Carlo noise, which falls as 1/sqrt(spp) — SHARD_NOISE_U8 /
# sqrt(spp) is over twice what the runs measure (4.6 u8 at 16 spp and 7.0
# at 8 spp on virtual CPU devices; 1.7 at 100 spp and 3.1 at 32 spp on
# four H100s) — and the images correlate.
SHARD_NOISE_U8 = 40.0
SHARD_CORRELATION = 0.97


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Phase 2: the card-only tests, in a child process.

def run_gpu_tests():
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, WRT_TEST_PLATFORM="gpu")
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", f"--junitxml={report}", "tests"],
            cwd=ROOT, env=env, capture_output=True, text=True)
        tail = "\n".join(proc.stdout.strip().splitlines()[-15:])
        if proc.returncode != 0:
            raise RuntimeError(f"gpu tests failed (rc {proc.returncode}):\n"
                               f"{tail}\n{proc.stderr[-3000:]}")
        suite = ET.parse(report).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = int(suite.get("tests"))
        skipped = int(suite.get("skipped"))
        if n == 0 or skipped:
            raise RuntimeError(f"gpu tests: {n} collected, {skipped} "
                               f"skipped; every one must run on the card")
    log(f"gpu tests: {n} passed")


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain reference.

def _t64(scene_np, o, d, tm, s):
    """float64 (t, disc, b^2) of rays o/d/tm [3|1, M] against spheres
    s [M] — the reference quadratic (ops/hit.py) in double precision."""
    import numpy as np

    c1 = scene_np["center1"][s].T.astype(np.float64)
    c2 = scene_np["center2"][s].T.astype(np.float64)
    t1, t2 = scene_np["t1"][s], scene_np["t2"][s]
    lerp = (tm[0] - t1) / (t2 - t1)
    oc = o - (c1 + (c2 - c1) * lerp)
    a = (d * d).sum(0)
    b = (d * oc).sum(0)
    c = (oc * oc).sum(0) - scene_np["radius"][s].astype(np.float64) ** 2
    disc = b * b - a * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    return t, disc, b * b


def compare_hits(scene, ref, got, origin, direction, time_):
    """Kernel record ``got`` vs reference record ``ref`` (HitRecordRows)
    under the tolerances above.  Returns a summary dict; raises on any
    difference outside them."""
    import numpy as np

    rh, gh = np.asarray(ref.hit[0]), np.asarray(got.hit[0])
    ri, gi = np.asarray(ref.idx[0]), np.asarray(got.idx[0])
    rt, gt = np.asarray(ref.t[0]), np.asarray(got.t[0])
    same = (rh == gh) & (~rh | (ri == gi))
    rel = np.zeros_like(rt)
    both = rh & gh & (ri == gi)
    rel[both] = np.abs(gt[both] - rt[both]) / np.abs(rt[both])
    suspect = np.flatnonzero(~same | (rel > REL_T))
    sc = {f: np.asarray(getattr(scene, f)) for f in scene._fields}
    o = np.asarray(origin, np.float64)[:, suspect]
    d = np.asarray(direction, np.float64)[:, suspect]
    tm = np.asarray(time_, np.float64)[:, suspect]
    unexplained = []
    if len(suspect):
        t_r, disc_r, bb_r = _t64(sc, o, d, tm, ri[suspect])
        t_g, disc_g, bb_g = _t64(sc, o, d, tm, gi[suspect])
        tangent = ((np.abs(disc_r) <= TANGENT_REL * bb_r)
                   | (np.abs(disc_g) <= TANGENT_REL * bb_g))
        tie = (rh[suspect] & gh[suspect]
               & (np.abs(t_r - t_g) <= TIE_REL * np.abs(t_r)))
        unexplained = suspect[~(tangent | tie)]
    summary = {
        "lanes": int(rh.size), "hits": int(rh.sum()),
        "hit_flag_diffs": int((rh != gh).sum()),
        "winner_diffs": int((rh & gh & (ri != gi)).sum()),
        "max_rel_t": float(rel.max()),
        "explained_by_tie_or_tangency": int(len(suspect)
                                            - len(unexplained)),
    }
    if len(unexplained):
        raise AssertionError(f"kernel vs reference: {len(unexplained)} "
                             f"lanes outside tolerance {summary}")
    return summary


def kernel_rays(scene_cam, n, seed=0):
    """``n`` lanes: half the camera's primary rays (lens and shutter
    jitter), half scattered rays leaving points just above the ground —
    rows layout (origin [3, n], direction [3, n], time [1, n])."""
    import numpy as np
    import jax.numpy as jnp
    from win32_raytracer_tpu.ops.rows import camera_rays_rows

    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.uniform(0, 1, (1, n)), jnp.float32)
    v = jnp.asarray(rng.uniform(0, 1, (1, n)), jnp.float32)
    dr = jnp.asarray(rng.uniform(0, 1, (3, n)), jnp.float32)
    o, d, tm = camera_rays_rows(scene_cam, u, v, dr)
    o2 = np.stack([rng.uniform(-11, 11, n), rng.uniform(0.01, 1.5, n),
                   rng.uniform(-11, 11, n)])
    d2 = rng.normal(size=(3, n))
    d2[1] = np.abs(d2[1])
    even = (np.arange(n) % 2 == 0)[None]
    o = jnp.where(even, o, jnp.asarray(o2, jnp.float32))
    d = jnp.where(even, d, jnp.asarray(d2, jnp.float32))
    return o, d, tm


def check_kernel(scene, cam, n):
    """Kernel vs reference at ``n`` lanes, with warm device times."""
    import jax
    from win32_raytracer_tpu.kernels.hit_triton import hit_spheres_triton
    from win32_raytracer_tpu.ops.hit import hit_spheres
    from win32_raytracer_tpu.ops.rows import hit_rows_adapter

    o, d, tm = kernel_rays(cam, n)
    ref_fn = jax.jit(lambda o, d, t: hit_rows_adapter(hit_spheres)(
        scene, o, d, t))
    ker_fn = jax.jit(lambda o, d, t: hit_spheres_triton(scene, o, d, t))
    times = {}
    with jax.default_matmul_precision("highest"):
        for name, fn in (("reference", ref_fn), ("kernel", ker_fn)):
            rec = jax.block_until_ready(fn(o, d, tm))
            t0 = time.perf_counter()
            for _ in range(5):
                r = fn(o, d, tm)
            jax.block_until_ready(r)
            times[name + "_ms"] = round(
                (time.perf_counter() - t0) / 5 * 1e3, 3)
            if name == "reference":
                ref = rec
            else:
                got = rec
    return compare_hits(scene, ref, got, o, d, tm), times


def bounce_memory(scene, cam, n):
    """memory_analysis() of the hit and scatter+respawn programs."""
    import jax.numpy as jnp
    from win32_raytracer_tpu import persistent as P
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.kernels.hit_triton import hit_spheres_triton

    cfg = RenderConfig(width=1200, height=800, samples=100)
    scfg = P.step_cfg(cfg)
    o, d, tm = kernel_rays(cam, n)
    one = jnp.ones((1, n), jnp.int32)
    st = P.PathState(origin=o, direction=d, time=tm,
                     throughput=jnp.ones((3, n)),
                     radiance_sum=jnp.zeros((3, n)), depth=0 * one,
                     sample=0 * one, pixel=jnp.arange(n)[None] * one,
                     path_alive=one > 0, s_base=0 * one, s_quota=4 * one)
    hit = P.p_hit_step.lower(scene, st, cfg=scfg,
                             hit_fn=hit_spheres_triton).compile()
    rec, _ = P.p_hit_step(scene, st, cfg=scfg, hit_fn=hit_spheres_triton)
    dims = P.make_dims(cfg, 1200, 800, 100, 4)
    scat = P.p_scatter_respawn_step.lower(
        scene, cam, st, rec, jnp.uint32(1), jnp.int32(1), dims, cfg=scfg,
        lean=True).compile()
    out = {}
    for name, c in (("hit", hit), ("scatter_respawn", scat)):
        m = c.memory_analysis()
        out[name] = {k: int(getattr(m, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}
    return out


# ---------------------------------------------------------------------------
# Phases 5-7: renders.

def render_config2():
    """api.render (cold, then warm) and cli.main of config 2; both must
    equal the plain-XLA render of the same seed bit for bit (the kernel
    is exact against the reference, phase 3)."""
    import numpy as np
    from win32_raytracer_tpu import api, cli
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.io.image import read_image

    cfg = RenderConfig(width=1200, height=800, samples=100, seed=3)
    t0 = time.perf_counter()
    api.render("final", cfg=cfg)
    cold = time.perf_counter() - t0
    res = api.render("final", cfg=cfg)
    img = res.image
    if img.shape != (800, 1200, 3) or not 20 < img.mean() < 235:
        raise AssertionError(f"config 2 image {img.shape} mean {img.mean()}")
    # Against the plain-XLA render and the CLI's render of the same seed:
    # the hit records are exact (phase 3), so only rounding can move a
    # pixel — the flush's scatter-add runs on atomics, whose order varies
    # from run to run; allow that in at most PLAIN_PIXELS of the pixels.
    def moved(other, what):
        frac = float((img != other).any(axis=2).mean())
        if frac > PLAIN_PIXELS:
            raise AssertionError(f"config 2: {what} differs from "
                                 f"api.render in {frac:.2%} of pixels")
        return frac

    plain = moved(api.render("final", cfg=cfg.replace(backend="jnp")).image,
                  "the plain-XLA render")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "config2.ppm")
        rc = cli.main(["1200", "800", "100", "--scene", "final",
                       "--seed", "3", "--out", out, "--quiet"])
        if rc != 0:
            raise AssertionError(f"CLI render exited {rc}")
        via_cli = moved(read_image(out), "the CLI's render")
    return {"cold_s": round(cold, 3),
            "warm_s": round(res.duration_ms / 1e3, 4),
            "mean_u8": round(float(img.mean()), 3),
            "pixels_differing_from_plain": plain,
            "pixels_differing_from_cli": via_cli}


def render_config4():
    import numpy as np
    from win32_raytracer_tpu import api
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.scene.builders import get_scene

    cfg = RenderConfig(width=800, height=450, samples=50, seed=3)
    t0 = time.perf_counter()
    res = api.render(get_scene("mesh20k"), cfg=cfg)
    img = res.image
    if img.shape != (450, 800, 3) or not 20 < img.mean() < 235:
        raise AssertionError(f"config 4 image {img.shape} mean {img.mean()}")
    warm = api.render(get_scene("mesh20k"), cfg=cfg)
    return {"cold_s": round(time.perf_counter() - t0
                            - warm.duration_ms / 1e3, 3),
            "warm_s": round(warm.duration_ms / 1e3, 4),
            "mean_u8": round(float(np.asarray(img).mean()), 3)}


def golden():
    """The deterministic golden cases of tests/test_golden.py on this
    device, against the native oracle (built from native/ by make)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_golden as g
    from win32_raytracer_tpu import oracle

    if not oracle.available():
        raise RuntimeError("native oracle did not build (make -C native)")
    cases = (g.test_exact_specular_reference_quirks,
             g.test_exact_specular_textbook_mode, g.test_exact_sky_only)
    for case in cases:
        case()
    return [c.__name__ for c in cases]


# ---------------------------------------------------------------------------
# Four GPUs.

def compare_images(a, b):
    """(mean |a-b|, correlation) of two u8 images or image stacks."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


def check_pair(name, sharded, single, spp):
    diff, corr = compare_images(sharded, single)
    log(f"  {name}: mean |diff| {diff:.3f} u8, correlation {corr:.5f}")
    if diff > SHARD_NOISE_U8 / spp ** 0.5 or corr < SHARD_CORRELATION:
        raise AssertionError(f"{name}: sharded render disagrees with one "
                             f"card (diff {diff}, corr {corr})")
    return {"mean_abs_u8": round(diff, 4), "correlation": round(corr, 6)}


def four_card_phases(still_cfg, fly_cfg, n_frames, n_dev=4):
    """Sharded stills and flythrough vs one card; returns their summary."""
    import numpy as np
    from win32_raytracer_tpu import api
    from win32_raytracer_tpu.animation import orbit_path, render_animation
    from win32_raytracer_tpu.parallel.shard import make_mesh
    from win32_raytracer_tpu.scene.builders import get_scene

    mesh = make_mesh(n_dev)
    out = {}
    single = api.render("final", cfg=still_cfg).image
    for mode in ("rows", "spp", "persistent"):
        api.render("final", cfg=still_cfg, mesh=mesh, shard_mode=mode)
        res = api.render("final", cfg=still_cfg, mesh=mesh, shard_mode=mode)
        out[mode] = check_pair(f"still/{mode}", res.image, single,
                               still_cfg.samples)
        out[mode]["warm_s"] = round(res.duration_ms / 1e3, 4)
    cams = orbit_path(n_frames=n_frames,
                      aspect_ratio=fly_cfg.width / fly_cfg.height)
    scene = get_scene("final")
    one = np.stack(render_animation(scene, cams, fly_cfg))
    many = np.stack(render_animation(scene, cams, fly_cfg, mesh=mesh,
                                     shard_mode="rows"))
    out["flythrough"] = check_pair("flythrough", many, one,
                                   fly_cfg.samples)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phases")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1

    from win32_raytracer_tpu.utils.device import nvidia_smi, require_gpu

    log(nvidia_smi())           # the card's name and power limit

    if not args.four:
        run_gpu_tests()         # child process, before JAX starts here

    from win32_raytracer_tpu._cache import enable_compile_cache
    enable_compile_cache()
    platform, kind, count = require_gpu(n_cards)
    log(f"jax: platform={platform} kind={kind} count={count}")

    if args.four:
        from win32_raytracer_tpu.config import RenderConfig
        summary = four_card_phases(
            RenderConfig(width=1200, height=800, samples=100, seed=3),
            RenderConfig(width=640, height=480, samples=32, seed=3),
            n_frames=8)
        log("four cards: " + json.dumps(summary))
    else:
        from win32_raytracer_tpu.scene.builders import get_scene
        from win32_raytracer_tpu.scene.camera import default_camera

        final, cam = get_scene("final"), default_camera(1200, 800)
        for label, scene, c, n in (
                ("final scene, 4194304 lanes", final, cam, 1 << 22),
                ("test scene, 320000 lanes", get_scene("test"),
                 default_camera(400, 200), 320000)):
            summary, times = check_kernel(scene, c, n)
            log(f"kernel vs reference ({label}): {json.dumps(summary)} "
                f"{json.dumps(times)}")
        log("bounce memory_analysis: "
            + json.dumps(bounce_memory(final, cam, 1 << 22)))
        log("config 2 (1200x800@100, api.render + cli.main): "
            + json.dumps(render_config2()))
        log("config 4 (mesh20k 800x450@50): " + json.dumps(render_config4()))
        log("golden vs native oracle: " + json.dumps(golden()))

    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
