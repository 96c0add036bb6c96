"""Golden-image tests: JAX renderer vs the native reference-semantics oracle.

Two regimes (SURVEY.md §4):

* **Exact** — deterministic specular-only scenes (metal fuzz=0, dielectric
  with a forced branch, aperture 0, pixel centers): both renderers follow
  the same math with no randomness, so tonemapped images must agree to
  within f32 rounding (tiny u8 tolerance).
* **Statistical** — the canonical scenes with randomness on: the oracle uses
  the reference LCG + rejection sampling, the JAX renderer uses threefry +
  analytic sampling; identical distributions, different streams.  Mean
  tonemapped error must vanish as spp grows.
"""

import functools

import numpy as np
import pytest

from win32_raytracer_tpu import oracle
from win32_raytracer_tpu.config import RenderConfig
from win32_raytracer_tpu.core import materials as mat
from win32_raytracer_tpu.kernels.hit_triton import hit_spheres_triton
from win32_raytracer_tpu.render import render
from win32_raytracer_tpu.scene.builders import test_scene as make_test_scene
from win32_raytracer_tpu.scene.camera import make_camera
from win32_raytracer_tpu.scene.spheres import SceneBuilder

pytestmark = pytest.mark.skipif(
    not oracle.available(), reason="native oracle not built"
)

# Module-level so the hit function (a static jit argument) is one object.
_interpret_kernel = functools.partial(hit_spheres_triton, interpret=True)

CAM_ARGS = dict(look_from=(0.0, 1.0, 4.0), look_to=(0.0, 0.5, 0.0),
                up=(0.0, 1.0, 0.0), vfov_deg=45.0, aperture=0.0)


def _specular_scene():
    """Metal + dielectric only (no lambertian): deterministic scatter."""
    b = SceneBuilder()
    b.add_metal((0.0, 0.3, 0.0), 0.8, (0.9, 0.8, 0.7), 0.0)
    b.add_metal((-1.8, 0.2, -0.5), 0.6, (0.6, 0.7, 0.9), 0.0)
    b.add_dielectric((1.7, 0.3, 0.5), 0.6, 1.5)
    b.add_dielectric((1.7, 0.3, 0.5), -0.5, 1.5)  # hollow shell
    return b.build()


def _render_both(scene, cfg, focus=4.0):
    cam = make_camera(CAM_ARGS["look_from"], CAM_ARGS["look_to"], CAM_ARGS["up"],
                      CAM_ARGS["vfov_deg"], cfg.width / cfg.height,
                      CAM_ARGS["aperture"], focus)
    ours = render(scene, cam=cam, cfg=cfg)
    ref = oracle.oracle_render(
        scene, CAM_ARGS["look_from"], CAM_ARGS["look_to"], CAM_ARGS["up"],
        CAM_ARGS["vfov_deg"], CAM_ARGS["aperture"], focus, cfg,
        deterministic=cfg.deterministic,
    )
    return ours, ref


def test_exact_specular_reference_quirks():
    """Deterministic all-specular render, reference quirk mode: must match
    the oracle almost pixel-exactly (f32 associativity differences only)."""
    cfg = RenderConfig(width=96, height=64, samples=1, deterministic=True,
                       reflect_thres=2.0)  # dielectric branch fixed: refract
    ours, ref = _render_both(_specular_scene(), cfg)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 0.5, f"mean diff {diff.mean()}"
    assert (diff > 3).mean() < 0.01, f"big-pixel fraction {(diff > 3).mean()}"


def test_exact_specular_textbook_mode():
    """Same but with the textbook refract (bias 1.0) + schlick(ior)."""
    cfg = RenderConfig(width=96, height=64, samples=1, deterministic=True,
                       reflect_thres=2.0, refract_discriminant_bias=1.0,
                       schlick_uses_ni_over_nt=False)
    ours, ref = _render_both(_specular_scene(), cfg)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 0.5, f"mean diff {diff.mean()}"
    assert (diff > 3).mean() < 0.01


def test_exact_sky_only():
    """No scene hit at all: pure camera + sky gradient must match exactly."""
    b = SceneBuilder()
    b.add_metal((0.0, -500.0, 0.0), 1.0, (1, 1, 1), 0.0)  # far away, unseen
    cfg = RenderConfig(width=64, height=48, samples=1, deterministic=True)
    ours, ref = _render_both(b.build(), cfg)
    np.testing.assert_array_equal(ours, ref)


def test_statistical_test_scene():
    """Full test scene with randomness: different RNGs, same distribution.

    Uses the reference's own camera (RayTracer.cpp:903-915).
    """
    cfg = RenderConfig(width=64, height=32, samples=48, seed=9)
    scene = make_test_scene()
    from win32_raytracer_tpu.scene.camera import default_camera
    cam = default_camera(cfg.width, cfg.height)
    ours = render(scene, cam=cam, cfg=cfg)
    focus = float(np.linalg.norm(np.array([15.0, 2, 4]) - np.array([0.0, 1, 0])))
    ref = oracle.oracle_render(scene, (15, 2, 4), (0, 1, 0), (0, 1, 0),
                               20.0, 0.1, focus, cfg)
    diff = np.abs(ours.astype(float) - ref.astype(float))
    # Monte-Carlo noise at 48 spp after sqrt-tonemap: a few u8 steps.
    assert diff.mean() < 4.0, f"mean diff {diff.mean()}"


def test_statistical_random_scene():
    """The FULL 488-sphere RTIOW random scene (moving lambertians + mixed
    materials at depth 10) against the native oracle — round-1 VERDICT
    item 5a: the complete production render path had no oracle comparison
    at any resolution.  Different RNG streams, same distribution."""
    cfg = RenderConfig(width=96, height=64, samples=16, seed=11)
    from win32_raytracer_tpu.scene.builders import random_scene
    scene = random_scene()
    from win32_raytracer_tpu.scene.camera import default_camera
    cam = default_camera(cfg.width, cfg.height)
    ours = render(scene, cam=cam, cfg=cfg)
    focus = float(np.linalg.norm(np.array([15.0, 2, 4]) - np.array([0.0, 1, 0])))
    ref = oracle.oracle_render(scene, (15, 2, 4), (0, 1, 0), (0, 1, 0),
                               20.0, 0.1, focus, cfg)
    diff = np.abs(ours.astype(float) - ref.astype(float))
    # Monte-Carlo noise at 16 spp after sqrt-tonemap: a few u8 steps
    # (measures ~3-4 when correct; a wrong material/motion path is >>10).
    assert diff.mean() < 6.0, f"mean diff {diff.mean()}"
    # Spatial structure must agree too, not just the global mean.
    a = ours.astype(float).reshape(-1) - ours.mean()
    b = ref.astype(float).reshape(-1) - ref.mean()
    r = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    assert r > 0.97, f"structural correlation {r:.4f}"


def test_reference_lane_truncation_quirk_documented():
    """The reference's AVX loop drops size%8 trailing spheres
    (RayTracer.cpp:432-434): with the 6-sphere test scene that is *all* of
    them.  Our renderer must NOT reproduce that (it renders the scene);
    the oracle can emulate it for the record."""
    cfg = RenderConfig(width=32, height=16, samples=2, seed=1)
    scene = make_test_scene()
    focus = float(np.linalg.norm(np.array([15.0, 2, 4]) - np.array([0.0, 1, 0])))
    truncated = oracle.oracle_render(scene, (15, 2, 4), (0, 1, 0), (0, 1, 0),
                                     20.0, 0.1, focus, cfg, lane_truncate=8)
    full = oracle.oracle_render(scene, (15, 2, 4), (0, 1, 0), (0, 1, 0),
                                20.0, 0.1, focus, cfg)
    # Truncated render is pure sky; the real render is not.
    assert np.abs(truncated.astype(int) - full.astype(int)).mean() > 5.0
    from win32_raytracer_tpu.scene.camera import default_camera
    ours = render(scene, cam=default_camera(cfg.width, cfg.height), cfg=cfg)
    assert np.abs(ours.astype(float) - full.astype(float)).mean() < 16.0
    assert np.abs(ours.astype(float) - truncated.astype(float)).mean() > \
        np.abs(ours.astype(float) - full.astype(float)).mean()


def test_statistical_persistent_kernel_path(monkeypatch):
    """The GPU main path — persistent scheduler + the Triton sphere kernel
    (kernels/hit_triton.py) — pinned to the native oracle.  The kernel
    runs in Pallas interpret mode here; the compaction floor is patched
    to 0 so the render stays in the above-floor regime (split hit and
    scatter programs, compactions) instead of the below-floor one-shot
    program (test shapes are tiny)."""
    import win32_raytracer_tpu.persistent as P
    from win32_raytracer_tpu.render import tonemap
    from win32_raytracer_tpu.scene.camera import default_camera

    monkeypatch.setattr(P, "_COMPACT_FLOOR", 0)
    cfg = RenderConfig(width=48, height=32, samples=4, seed=13,
                       scheduler="persistent")
    scene = make_test_scene()
    ours = np.asarray(tonemap(P.render_image_persistent(
        scene, default_camera(cfg.width, cfg.height), cfg,
        hit_fn=_interpret_kernel)))
    focus = float(np.linalg.norm(np.array([15.0, 2, 4]) - np.array([0.0, 1, 0])))
    ref = oracle.oracle_render(scene, (15, 2, 4), (0, 1, 0), (0, 1, 0),
                               20.0, 0.1, focus, cfg)
    diff = np.abs(ours.astype(float) - ref.astype(float))
    # Measures 2.3 at 4 spp (different RNG streams); bound ~2x measured.
    assert diff.mean() < 5.0, f"mean diff {diff.mean():.2f}"
    a = ours.astype(float).reshape(-1) - ours.mean()
    b = ref.astype(float).reshape(-1) - ref.mean()
    r = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    # Measures 0.990; bound well above a structural break, below noise.
    assert r > 0.97, f"structural correlation {r:.4f}"
