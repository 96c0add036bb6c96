"""Triangle geometry: Möller-Trumbore vs a scalar oracle, meshes, and
composite-scene rendering (BASELINE.json config 4)."""

import numpy as np

import jax.numpy as jnp

from win32_raytracer_tpu.config import RenderConfig
from win32_raytracer_tpu.core import materials as mat
from win32_raytracer_tpu.ops.hit_tri import hit_triangles
from win32_raytracer_tpu.render import render
from win32_raytracer_tpu.scene.builders import mesh_scene
from win32_raytracer_tpu.scene.composite import CompositeScene
from win32_raytracer_tpu.scene.triangles import (
    box_mesh, build_triangle_scene, icosphere_mesh, load_obj)


def scalar_tri_oracle(v0, e1, e2, o, d, min_t=1e-3):
    """Double-precision Möller-Trumbore for one ray against all tris."""
    best_t, best_i = np.inf, -1
    for i in range(len(v0)):
        p = np.cross(d, e2[i])
        det = e1[i] @ p
        if abs(det) < 1e-9:
            continue
        tv = o - v0[i]
        u = (tv @ p) / det
        q = np.cross(tv, e1[i])
        v = (d @ q) / det
        t = (e2[i] @ q) / det
        if u >= 0 and v >= 0 and u + v <= 1 and min_t < t < best_t:
            best_t, best_i = t, i
    return best_t, best_i


def test_vs_scalar_oracle():
    verts, faces = icosphere_mesh((0, 0, 0), 1.0, subdivisions=1)
    scene = build_triangle_scene(verts, faces, mat_id=mat.LAMBERTIAN,
                                 albedo=(0.5, 0.5, 0.5))
    tri = verts[faces]
    v0 = tri[:, 0].astype(np.float64)
    e1 = (tri[:, 1] - tri[:, 0]).astype(np.float64)
    e2 = (tri[:, 2] - tri[:, 0]).astype(np.float64)

    rng = np.random.default_rng(0)
    o = rng.uniform(-4, 4, (64, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    rec = hit_triangles(scene, jnp.asarray(o), jnp.asarray(d),
                        jnp.zeros((64,)))
    for i in range(64):
        want_t, want_j = scalar_tri_oracle(v0, e1, e2,
                                           o[i].astype(np.float64),
                                           d[i].astype(np.float64))
        got_hit = bool(np.asarray(rec.hit)[i])
        if want_j < 0:
            assert not got_hit
        else:
            assert got_hit
            np.testing.assert_allclose(float(np.asarray(rec.t)[i]), want_t,
                                       rtol=1e-3)


def test_two_sided_and_normal():
    """A single triangle is hittable from both sides; unit normal."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int64)
    scene = build_triangle_scene(v, f, mat_id=mat.METAL,
                                 albedo=(1, 1, 1), fuzz=0.0)
    o = jnp.asarray([[0.2, 0.2, 1.0], [0.2, 0.2, -1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    rec = hit_triangles(scene, o, d, jnp.zeros((2,)))
    assert bool(rec.hit[0]) and bool(rec.hit[1])
    np.testing.assert_allclose(np.asarray(rec.t), [1.0, 1.0], rtol=1e-5)
    np.testing.assert_allclose(np.abs(np.asarray(rec.normal)[:, 2]),
                               [1.0, 1.0], atol=1e-6)


def test_mesh_scene_renders():
    scene = mesh_scene()
    assert isinstance(scene, CompositeScene)
    cfg = RenderConfig(width=48, height=32, samples=2, seed=5, backend="jnp")
    img = render(scene, cfg=cfg)
    assert img.shape == (32, 48, 3)
    assert img[0, 0, 2] > 180  # sky up top
    # the meshes occupy the center: not pure sky there
    center = img[16:28, 12:36].astype(float)
    sky = img[0:2].astype(float).mean(axis=(0, 1))
    assert np.abs(center - sky).mean() > 5.0


def test_box_mesh_watertight_silhouette():
    """Rays at a box from +z: hits exactly within the face bounds."""
    v, f = box_mesh((0, 0, 0), (1, 1, 1))
    scene = build_triangle_scene(v, f, mat_id=mat.LAMBERTIAN, albedo=(1, 0, 0))
    xs = jnp.linspace(-0.9, 0.9, 10)
    o = jnp.stack([xs, jnp.zeros(10), jnp.full((10,), 3.0)], axis=1)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (10, 1))
    rec = hit_triangles(scene, o, d, jnp.zeros((10,)))
    want = np.abs(np.asarray(xs)) <= 0.5
    np.testing.assert_array_equal(np.asarray(rec.hit), want)
    np.testing.assert_allclose(np.asarray(rec.t)[want], 2.5, rtol=1e-5)


def test_obj_roundtrip(tmp_path):
    v, f = box_mesh((0, 0, 0), (2, 2, 2))
    p = tmp_path / "box.obj"
    with open(p, "w") as fh:
        for vv in v:
            fh.write(f"v {vv[0]} {vv[1]} {vv[2]}\n")
        for ff in f:
            fh.write(f"f {ff[0]+1} {ff[1]+1} {ff[2]+1}\n")
    v2, f2 = load_obj(str(p))
    np.testing.assert_allclose(v2, v, rtol=1e-6)
    np.testing.assert_array_equal(f2, f)
