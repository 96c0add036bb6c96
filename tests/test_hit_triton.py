"""The Triton sphere-hit kernel (kernels/hit_triton.py) against the plain
sweep (ops/hit.py).

On the CPU the kernel runs in Pallas interpret mode; the tests marked
``gpu`` compile it for the card (chip_smoke.py runs them there).  The
comparison rules — identical hit flags and winners, t within a few ulps,
near-ties and tangent rays exempt — are chip_smoke.compare_hits, the same
ones the chip run applies at full width."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke
from win32_raytracer_tpu.core import materials as mat
from win32_raytracer_tpu.kernels.hit_triton import (
    hit_spheres_triton, kernel_table)
from win32_raytracer_tpu.ops.hit import hit_spheres
from win32_raytracer_tpu.ops.rows import hit_rows_adapter
from win32_raytracer_tpu.scene.builders import get_scene
from win32_raytracer_tpu.scene.camera import default_camera
from win32_raytracer_tpu.scene.spheres import SceneBuilder

_reference = jax.jit(hit_rows_adapter(hit_spheres))


def _rays(n, seed=0, t_hi=0.05):
    """Camera rays of the reference camera mixed with rays scattered from
    just above the ground (chip_smoke.kernel_rays), shutter in [0, t_hi]."""
    o, d, tm = chip_smoke.kernel_rays(default_camera(400, 200), n, seed)
    return o, d, tm * (t_hi / 0.05)


def _glass_scene():
    """Hollow glass: a dielectric shell (negative inner radius flips the
    normals) plus a metal sphere inside it."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
    b.add_dielectric((0.0, 0.5, 0.0), 1.0, 1.5)
    b.add_dielectric((0.0, 0.5, 0.0), -0.9, 1.5)
    b.add_metal((0.0, 0.5, 0.0), 0.3, (0.7, 0.6, 0.5), 0.1)
    return b.build()


def _inactive_scene():
    """Padding lanes plus a deactivated sphere in front of the others: it
    must never win, however near it is."""
    b = SceneBuilder()
    b.add_metal((0.0, 1.0, 6.0), 1.5, (0.9, 0.9, 0.9), 0.0)   # blocker
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.add_lambertian((0.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    sc = b.build()
    return sc._replace(active=sc.active.at[0].set(False))


def _tie_scene():
    """Exact ties: sphere 2 duplicates sphere 1, and sphere 130 (second
    128-sphere tile) duplicates sphere 3; the lower index must win."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    b.add_lambertian((4.0, 1.0, 0.0), 1.0, (0.1, 0.2, 0.3))
    b.add_dielectric((-4.0, 1.0, 0.0), 1.0, 1.5)
    for i in range(126):
        b.add_lambertian((100.0 + i, 50.0, 0.0), 0.1, (0.1, 0.1, 0.1))
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.9, 0.1, 0.1))
    return b.build()


CASES = {
    # name: (scene factory, lanes, block, shutter upper bound)
    "test_scene": (lambda: get_scene("test"), 384, 128, 0.05),
    "final_scene": (lambda: get_scene("final"), 512, 256, 0.05),
    "motion_blur": (lambda: get_scene("final"), 384, 128, 1.0),
    "hollow_glass": (_glass_scene, 384, 128, 0.05),
    "inactive_spheres": (_inactive_scene, 384, 128, 0.05),
    "exact_ties": (_tie_scene, 384, 128, 0.05),
    "ragged_lanes": (lambda: get_scene("test"), 333, 128, 0.05),
    "block_256": (lambda: get_scene("test"), 512, 256, 0.05),
    "block_512": (lambda: get_scene("test"), 700, 512, 0.05),
}


def _check(scene, got, ref, o, d, tm):
    chip_smoke.compare_hits(scene, ref, got, o, d, tm)
    for f in ("hit", "idx", "mat_id", "albedo", "fuzz", "ior"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("point", "normal"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_interpret_matches_reference(case):
    make, n, block, t_hi = CASES[case]
    scene = make()
    o, d, tm = _rays(n, seed=len(case), t_hi=t_hi)
    got = hit_spheres_triton(scene, o, d, tm, block=block, interpret=True)
    ref = _reference(scene, o, d, tm)
    _check(scene, got, ref, o, d, tm)
    assert got.t.shape == (1, n) and got.normal.shape == (3, n)
    assert bool(np.asarray(got.hit).any())


@pytest.mark.parametrize("min_t", [0.0, 0.5, 5.0])
def test_kernel_min_t(min_t):
    """The near-t threshold (reference 0.001) reaches the kernel: hits at
    or before min_t are rejected exactly like the plain sweep does."""
    scene = get_scene("final")
    o, d, tm = _rays(384, seed=3)
    got = hit_spheres_triton(scene, o, d, tm, min_t=min_t, block=128,
                             interpret=True)
    ref = jax.jit(hit_rows_adapter(hit_spheres), static_argnames="min_t")(
        scene, o, d, tm, min_t=min_t)
    _check(scene, got, ref, o, d, tm)
    t = np.asarray(got.t)[np.asarray(got.hit)]
    assert (t > min_t).all()


def test_kernel_ties_keep_lowest_index():
    """Rays straight at the duplicated spheres hit exactly tied t: the
    winners are spheres 1 and 3, never their duplicates 2 and 130."""
    scene = _tie_scene()
    o = jnp.asarray([[4.0, -4.0], [1.0, 1.0], [10.0, 10.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0], [0.0, 0.0], [-1.0, -1.0]], jnp.float32)
    tm = jnp.zeros((1, 2), jnp.float32)
    got = hit_spheres_triton(scene, o, d, tm, block=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.idx)[0], [1, 3])
    np.testing.assert_array_equal(np.asarray(_reference(scene, o, d,
                                                        tm).idx)[0], [1, 3])


def test_kernel_table_flags_inactive_spheres():
    scene = _inactive_scene()
    tab = np.asarray(kernel_table(scene))
    np.testing.assert_array_equal(tab[:, 15], np.asarray(scene.active))
    assert tab.shape == (scene.padded_size, 16)


def test_kernel_rejects_non_power_of_two_block():
    o, d, tm = _rays(64)
    with pytest.raises(ValueError, match="power of two"):
        hit_spheres_triton(get_scene("test"), o, d, tm, block=96,
                           interpret=True)


# ---------------------------------------------------------------------------
# On the card.

@pytest.mark.gpu
@pytest.mark.parametrize("name", ["test", "final"])
def test_kernel_on_gpu_matches_reference(gpu_device, name):
    scene = get_scene(name)
    o, d, tm = _rays(1 << 16, seed=5)
    got = jax.jit(lambda o, d, t: hit_spheres_triton(scene, o, d, t))(
        o, d, tm)
    with jax.default_matmul_precision("highest"):
        ref = _reference(scene, o, d, tm)
    assert got.t.devices() == {gpu_device}
    _check(scene, got, ref, o, d, tm)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["jnp", "kernel"])
def test_winner_attributes_exact_on_gpu(gpu_device, path):
    """The winner's attributes come back bit-exact on the card: a TF32
    contraction (10 mantissa bits) would truncate these to ~3 digits."""
    b = SceneBuilder()
    b.add_metal((3.7312345, 1.0987654, -9.4123457), 0.9876543,
                (0.12345679, 0.87654321, 0.55555557), 0.31415927)
    b.add_dielectric((-9.4123457, 1.0987654, 3.7312345), 0.9876543,
                     1.3333334)
    scene = b.build()
    o = jnp.asarray([[3.7312345, -9.4123457], [1.0987654, 1.0987654],
                     [10.0, 20.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0], [0.0, 0.0], [-1.0, -1.0]], jnp.float32)
    tm = jnp.zeros((1, 2), jnp.float32)
    fn = (hit_rows_adapter(hit_spheres) if path == "jnp"
          else hit_spheres_triton)
    rec = jax.jit(lambda o, d, t: fn(scene, o, d, t))(o, d, tm)
    np.testing.assert_array_equal(np.asarray(rec.idx)[0], [0, 1])
    np.testing.assert_array_equal(np.asarray(rec.mat_id)[0],
                                  [mat.METAL, mat.DIELECTRIC])
    np.testing.assert_array_equal(np.asarray(rec.albedo)[:, 0],
                                  np.asarray(scene.albedo)[0])
    np.testing.assert_array_equal(np.asarray(rec.fuzz)[0, 0],
                                  np.asarray(scene.fuzz)[0])
    np.testing.assert_array_equal(np.asarray(rec.ior)[0, 1],
                                  np.asarray(scene.ior)[1])
    # A head-on hit's normal has no x/y part exactly when the centre came
    # back exact (a TF32 centre would be off by ~1e-3).
    np.testing.assert_array_equal(np.asarray(rec.normal)[:2, :], 0.0)
    np.testing.assert_allclose(np.asarray(rec.normal)[2, 0], 1.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The kernel inside the renderer (interpret mode).

_interpret = functools.partial(hit_spheres_triton, block=128, interpret=True)


@pytest.mark.parametrize("name", ["test", "final"])
def test_column_wrapper_matches_column_sweep(name):
    """dispatch._columns turns the rows kernel into the ops.hit column
    interface the wavefront scheduler uses."""
    from win32_raytracer_tpu.kernels.dispatch import _columns

    scene = get_scene(name)
    o, d, tm = _rays(256, seed=9)
    col = _columns(_interpret)(scene, o.T, d.T, tm[0])
    ref = hit_spheres(scene, o.T, d.T, tm[0])
    np.testing.assert_array_equal(np.asarray(col.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(np.asarray(col.hit), np.asarray(ref.hit))
    np.testing.assert_allclose(np.asarray(col.point), np.asarray(ref.point),
                               rtol=1e-5, atol=1e-4)
    assert col.normal.shape == ref.normal.shape == (256, 3)


def _close_images(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    # Same draws, same hits up to rounding: only a path that a last-ulp
    # t difference re-routes can move a pixel.
    assert np.abs(a - b).mean() < 2e-3, np.abs(a - b).mean()


def test_persistent_render_with_kernel():
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.persistent import render_image_persistent

    cfg = RenderConfig(width=32, height=16, samples=8, seed=2,
                       scheduler="persistent")
    scene = get_scene("test")
    got = render_image_persistent(scene, None, cfg, hit_fn=_interpret)
    ref = render_image_persistent(scene, None, cfg,
                                  hit_fn=hit_rows_adapter(hit_spheres))
    _close_images(got, ref)


@pytest.mark.parametrize("mode", ["rows", "spp", "persistent"])
def test_sharded_render_with_kernel(mode, eight_devices):
    """The kernel inside shard_map (four virtual devices): the sharded
    drivers run it per shard like the plain sweep."""
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.kernels.dispatch import _columns
    from win32_raytracer_tpu.parallel.shard import (make_mesh,
                                                    render_image_sharded)

    cfg = RenderConfig(width=32, height=16, samples=8, seed=2)
    mesh = make_mesh(4)
    scene = get_scene("test")
    kern, ref = ((_interpret, hit_rows_adapter(hit_spheres))
                 if mode == "persistent"
                 else (_columns(_interpret), hit_spheres))
    got = render_image_sharded(scene, None, cfg, mesh, mode=mode,
                               hit_fn=kern)
    want = render_image_sharded(scene, None, cfg, mesh, mode=mode,
                                hit_fn=ref)
    _close_images(got, want)
