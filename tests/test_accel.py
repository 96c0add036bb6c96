"""Uniform-grid acceleration: conservativeness + exactness vs brute force.

The grid path must produce the SAME nearest hit as the brute sweep
(ops.hit.hit_spheres) for every ray — the footprint mask may only skip
tiles that cannot contain an unoccluded hit.  Rays are drawn adversarially:
camera-like primaries, bounce-like origins on geometry, in-slab grazers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from win32_raytracer_tpu.accel import (
    build_grid_accel, hit_spheres_grid_jnp, footprint_block_mask)
from win32_raytracer_tpu.ops.hit import hit_spheres
from win32_raytracer_tpu.scene.builders import (
    random_scene, test_scene as make_test_scene)


@pytest.fixture(scope="module")
def scene():
    return random_scene()


@pytest.fixture(scope="module")
def gscene(scene):
    g = build_grid_accel(scene, time_hi=0.05)
    assert g is not None
    return g


def _ray_batch(n, seed, mode):
    rng = np.random.default_rng(seed)
    if mode == "primary":
        o = np.tile([15.0, 2.0, 4.0], (n, 1)) + rng.normal(0, 0.05, (n, 3))
        target = rng.uniform([-12, 0, -12], [12, 2.5, 12], (n, 3))
        d = target - o
    elif mode == "bounce":
        # Origins on/near the lattice and ground, any direction.
        o = rng.uniform([-12, 0.0, -12], [12, 0.6, 12], (n, 3))
        d = rng.normal(0, 1, (n, 3))
    elif mode == "grazing":
        # Nearly horizontal rays inside the slab: worst-case footprints.
        o = rng.uniform([-12, 0.05, -12], [12, 0.5, 12], (n, 3))
        d = rng.normal(0, 1, (n, 3))
        d[:, 1] *= 0.01
    else:
        raise ValueError(mode)
    # Normalize (renders trace O(1)-length directions): tiny fma-level t
    # differences scale into point/normal error by |d|, so huge |d| would
    # only test tolerance arithmetic, not the grid logic.
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 0.05, (n,))
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(t, jnp.float32))


def _is_grazing(scene, o, d, t, lane, tol=1e-4):
    """True if ray `lane` has a near-zero f64 discriminant against some
    sphere — i.e. hit/no-hit legitimately depends on fma rounding."""
    ov = np.asarray(o, np.float64)[lane]
    dv = np.asarray(d, np.float64)[lane]
    tm = float(np.asarray(t)[lane])
    c1 = np.asarray(scene.center1, np.float64)
    c2 = np.asarray(scene.center2, np.float64)
    t1 = np.asarray(scene.t1, np.float64)
    t2 = np.asarray(scene.t2, np.float64)
    r = np.asarray(scene.radius, np.float64)
    act = np.asarray(scene.active)
    lerp = (tm - t1) / (t2 - t1)
    c = c1 + (c2 - c1) * lerp[:, None]
    oc = ov[None, :] - c
    b_half = oc @ dv
    a = dv @ dv
    cc = (oc * oc).sum(axis=1) - r * r
    disc = b_half * b_half - a * cc
    scale = np.maximum(b_half * b_half, 1e-12)
    return bool((act & (np.abs(disc) / scale < tol)).any())


@pytest.mark.parametrize("mode", ["primary", "bounce", "grazing"])
def test_grid_matches_brute(scene, gscene, mode):
    o, d, t = _ray_batch(
        1536, seed={"primary": 11, "bounce": 22, "grazing": 33}[mode],
        mode=mode)
    ref = jax.jit(hit_spheres, static_argnames=())(scene, o, d, t)
    got = hit_spheres_grid_jnp(gscene, o, d, t, ray_block=256)

    # The two paths fuse the quadratic differently (XLA fma contraction for
    # a [N,128]-tile scan vs small grid tiles), so *grazing* rays — whose
    # discriminant is the difference of two large near-equal values — may
    # legitimately flip hit/no-hit.  Every disagreement must be provably
    # grazing (f64 discriminant ~ 0); anything else is a skipped tile that
    # mattered, i.e. a real conservativeness bug.
    h_ref = np.asarray(ref.hit)
    h_got = np.asarray(got.hit)
    agree = (h_ref == h_got) & (np.asarray(ref.idx) == np.asarray(got.idx))
    agree |= ~h_ref & ~h_got   # miss lanes carry meaningless attr values
    for lane in np.flatnonzero(~agree):
        assert _is_grazing(scene, o, d, t, lane), (
            f"lane {lane}: non-grazing hit mismatch "
            f"(ref idx {np.asarray(ref.idx)[lane]}, "
            f"got idx {np.asarray(got.idx)[lane]})")
    assert float((~agree).mean()) < 0.005  # grazers are rare

    ok = agree & h_ref
    np.testing.assert_array_equal(np.asarray(got.mat_id)[ok],
                                  np.asarray(ref.mat_id)[ok])
    np.testing.assert_allclose(np.asarray(got.t)[ok], np.asarray(ref.t)[ok],
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.normal)[ok],
                               np.asarray(ref.normal)[ok], rtol=0, atol=2e-2)


def test_mask_saves_work(gscene):
    """Sanity: spatially-local blocks (the real case — wavefront lanes are
    pixel-ordered, so a block's bounce origins cluster on nearby geometry)
    must not test every tile; sky-ward blocks should test none."""
    rng = np.random.default_rng(7)
    n, rb = 4096, 256
    centers = rng.uniform([-11, 0.0, -11], [11, 0.4, 11], (n // rb, 3))
    o = (np.repeat(centers, rb, axis=0)
         + rng.uniform(-0.5, 0.5, (n, 3)) * [1.0, 0.4, 1.0])
    # Lambertian-like bounce dirs (normal + unit ball, ground normal = up):
    # on real renders, bounce-depth masks sit near 0.5 and primaries
    # near 0.13.
    d = rng.normal(0, 0.55, (n, 3)) + [0.0, 1.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)

    t_g = jnp.full((n,), np.float32(1e30))
    mask = footprint_block_mask(gscene, o, d, t_g, 0.001, rb)
    frac = float(mask.mean())
    assert frac < 0.75, frac  # local blocks skip a good share of tiles

    up = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n, 1))
    o_up = o.at[:, 1].set(5.0)  # above the slab, pointing away
    mask_up = footprint_block_mask(gscene, o_up, up, t_g, 0.001, rb)
    assert float(mask_up.mean()) == 0.0


def test_small_scene_declines():
    assert build_grid_accel(make_test_scene()) is None
