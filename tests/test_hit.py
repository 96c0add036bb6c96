"""Hit-kernel tests vs a scalar NumPy oracle (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from win32_raytracer_tpu.core import materials as mat
from win32_raytracer_tpu.ops.hit import hit_spheres, F32_MAX
from win32_raytracer_tpu.scene.builders import test_scene as make_test_scene, random_scene
from win32_raytracer_tpu.scene.spheres import SceneBuilder


def scalar_oracle(scene, o, d, tm, min_t=0.001):
    """Straight NumPy transliteration of the hit semantics
    (RayTracer.cpp:433-589): near root only, disc >= 0, t > min_t,
    strictly-nearest wins (earliest index on ties)."""
    c1 = np.asarray(scene.center1, np.float64)
    c2 = np.asarray(scene.center2, np.float64)
    t1 = np.asarray(scene.t1, np.float64)
    t2 = np.asarray(scene.t2, np.float64)
    rad = np.asarray(scene.radius, np.float64)
    act = np.asarray(scene.active)

    best_t, best_i = np.inf, -1
    for j in range(len(rad)):
        if not act[j]:
            continue
        lerp = (tm - t1[j]) / (t2[j] - t1[j])
        c = c1[j] + (c2[j] - c1[j]) * lerp
        oc = o - c
        a = d @ d
        b = 2.0 * (d @ oc)
        cc = oc @ oc - rad[j] * rad[j]
        disc = b * b - 4 * a * cc
        if disc < 0:
            continue
        t = (-b - np.sqrt(disc)) / (2 * a)
        if t > min_t and t < best_t:
            best_t, best_i = t, j
    return best_t, best_i


def _check_batch(scene, rng, n=64, spread=20.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    tm = rng.uniform(0, 0.05, (n,)).astype(np.float32)
    rec = jax.jit(hit_spheres)(scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    rec = jax.tree.map(np.asarray, rec)
    for i in range(n):
        want_t, want_j = scalar_oracle(scene, o[i].astype(np.float64),
                                       d[i].astype(np.float64), float(tm[i]))
        if want_j < 0:
            assert not rec.hit[i], (i, rec.t[i], want_t)
            continue
        assert rec.hit[i], (i, want_t, want_j)
        np.testing.assert_allclose(rec.t[i], want_t, rtol=2e-4, atol=1e-5)
        # Index may differ from the oracle only by f32-vs-f64 rounding of a
        # near tie; the returned t already matched above.
        if rec.idx[i] != want_j:
            assert bool(np.asarray(scene.active)[rec.idx[i]])
        # point/normal consistency.
        np.testing.assert_allclose(
            rec.point[i], o[i] + rec.t[i] * d[i], rtol=1e-4, atol=1e-5)
        r = float(np.asarray(scene.radius)[rec.idx[i]])
        np.testing.assert_allclose(
            np.linalg.norm(rec.normal[i]), 1.0, rtol=3e-3)
        # Negative radius flips the normal outward->inward.
        c1 = np.asarray(scene.center1)[rec.idx[i]]
        c2 = np.asarray(scene.center2)[rec.idx[i]]
        tt1 = float(np.asarray(scene.t1)[rec.idx[i]])
        tt2 = float(np.asarray(scene.t2)[rec.idx[i]])
        center = c1 + (c2 - c1) * ((float(tm[i]) - tt1) / (tt2 - tt1))
        outward = (rec.point[i] - center) / np.linalg.norm(rec.point[i] - center)
        sign = 1.0 if r > 0 else -1.0
        np.testing.assert_allclose(rec.normal[i], sign * outward, atol=3e-3)


def test_vs_oracle_test_scene():
    _check_batch(make_test_scene(), np.random.default_rng(0), n=64, spread=5.0)


def test_vs_oracle_random_scene():
    _check_batch(random_scene(), np.random.default_rng(1), n=48, spread=15.0)


def test_no_hit_behind_ray():
    s = make_test_scene()
    o = jnp.asarray([[10.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])  # pointing away from everything
    rec = hit_spheres(s, o, d, jnp.zeros((1,)))
    assert not bool(rec.hit[0])
    assert float(rec.t[0]) == float(F32_MAX)


def test_min_t_threshold():
    """A hit closer than min_t (0.001) is rejected (RayTracer.cpp:430)."""
    b = SceneBuilder()
    b.add_lambertian((0.0, 0.0, 0.0), 1.0, (1, 1, 1))
    s = b.build()
    # Origin on the sphere surface, shooting outward: the only root is t=0-ish
    o = jnp.asarray([[1.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    rec = hit_spheres(s, o, d, jnp.zeros((1,)))
    assert not bool(rec.hit[0])
    # Shooting inward from the surface: the near root is t=0 (rejected) and
    # back faces are not drawn (reference TODO, RayTracer.cpp:496-511), so
    # this is a miss too — semantics preserved.
    rec = hit_spheres(s, o, -d, jnp.zeros((1,)))
    assert not bool(rec.hit[0])
    # From just outside, the near root is a real hit.
    rec = hit_spheres(s, jnp.asarray([[2.0, 0.0, 0.0]]), -d, jnp.zeros((1,)))
    assert bool(rec.hit[0])
    np.testing.assert_allclose(float(rec.t[0]), 1.0, rtol=1e-5)


def test_motion_blur_center_lerp():
    """Moving sphere evaluated at shutter time (RayTracer.cpp:449-452)."""
    b = SceneBuilder()
    b.add_moving((0, 0, 0), (0, 3, 0), 0.0, 1.0, 0.5, mat.LAMBERTIAN,
                 albedo=(1, 1, 1))
    s = b.build()
    o = jnp.asarray([[0.0, 1.5, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    # At t=0 the sphere is at y=0 -> miss at height 1.5.
    rec0 = hit_spheres(s, o, d, jnp.asarray([0.0]))
    assert not bool(rec0.hit[0])
    # At t=0.5 the center is at y=1.5 -> dead-center hit at z=0.5.
    rec5 = hit_spheres(s, o, d, jnp.asarray([0.5]))
    assert bool(rec5.hit[0])
    np.testing.assert_allclose(float(rec5.t[0]), 4.5, rtol=1e-5)


def test_padding_never_hits():
    s = make_test_scene()
    # Fire rays everywhere; winning index must always be < 6 (active count).
    rng = np.random.default_rng(7)
    o = jnp.asarray(rng.uniform(-50, 50, (256, 3)), jnp.float32)
    d = jnp.asarray(rng.uniform(-1, 1, (256, 3)), jnp.float32)
    rec = jax.jit(hit_spheres)(s, o, d, jnp.zeros((256,)))
    idx = np.asarray(rec.idx)[np.asarray(rec.hit)]
    assert idx.size == 0 or idx.max() < 6


def _onehot_sweep(scene, origin, direction, time, min_t=0.001, tile=128):
    """The former winner fetch — a first-occurrence one-hot matrix
    product per tile, carried across tiles — kept here as the reference
    the exact ``argmin`` + ``take`` gather must reproduce bit for bit."""
    from win32_raytracer_tpu.ops.hit import ATTR_COLS, _attr_matrix

    k = scene.padded_size // tile
    tiles = _attr_matrix(scene).reshape(k, tile, ATTR_COLS)
    active = scene.active.astype(jnp.float32).reshape(k, tile)
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    a = dx * dx + dy * dy + dz * dz
    tcol = time[:, None]

    def body(carry, args):
        tl, act = args
        best_t, best_a = carry
        lerp = (tcol - tl[:, 6][None]) * tl[:, 7][None]
        cx = tl[:, 0][None] + tl[:, 3][None] * lerp
        cy = tl[:, 1][None] + tl[:, 4][None] * lerp
        cz = tl[:, 2][None] + tl[:, 5][None] * lerp
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - tl[:, 8][None] ** 2
        disc = b * b - a * c
        t = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / a
        t = jnp.where((disc >= 0) & (t > min_t) & (act[None] > 0.5), t,
                      F32_MAX)
        tile_t = jnp.min(t, axis=1)
        eq = (t == tile_t[:, None]).astype(jnp.float32)
        onehot = eq * (jnp.cumsum(eq, axis=1) == 1.0)
        sel = jnp.dot(onehot, tl, precision=jax.lax.Precision.HIGHEST)
        better = tile_t < best_t
        return (jnp.where(better, tile_t, best_t),
                jnp.where(better[:, None], sel, best_a)), None

    n = origin.shape[0]
    init = (jnp.full((n,), F32_MAX), jnp.zeros((n, ATTR_COLS), jnp.float32))
    (best_t, best_a), _ = jax.lax.scan(body, init, (tiles, active))
    return best_t, best_a


@pytest.mark.parametrize("scene_name,t_hi", [("test", 0.05), ("final", 0.05),
                                             ("final", 1.0)])
def test_exact_gather_matches_onehot_contraction(scene_name, t_hi):
    """The argmin + take winner fetch returns exactly the rows the one-hot
    contraction did (idx/material/albedo bit-identical, t identical)."""
    from win32_raytracer_tpu.scene.builders import get_scene

    scene = get_scene(scene_name)
    rng = np.random.default_rng(4)
    n = 512
    o = np.stack([rng.uniform(-12, 12, n), rng.uniform(0.05, 3, n),
                  rng.uniform(-12, 12, n)], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tm = rng.uniform(0, t_hi, n).astype(np.float32)
    rec = jax.jit(hit_spheres)(scene, o, d, tm)
    ref_t, ref_a = jax.jit(_onehot_sweep)(scene, o, d, tm)
    ref_t, ref_a = np.asarray(ref_t), np.asarray(ref_a)
    hit = np.asarray(rec.hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(np.asarray(rec.t), ref_t)
    np.testing.assert_array_equal(np.asarray(rec.idx)[hit],
                                  ref_a[hit, 15].astype(np.int32))
    np.testing.assert_array_equal(np.asarray(rec.mat_id)[hit],
                                  ref_a[hit, 9].astype(np.int32))
    np.testing.assert_array_equal(np.asarray(rec.albedo)[hit],
                                  ref_a[hit, 10:13])
    np.testing.assert_array_equal(np.asarray(rec.fuzz)[hit], ref_a[hit, 13])
    np.testing.assert_array_equal(np.asarray(rec.ior)[hit], ref_a[hit, 14])
