"""shard_map tile parallelism on the virtual 8-device CPU mesh
(a fake backend, SURVEY.md §4)."""

import numpy as np
import pytest

import jax

from win32_raytracer_tpu.config import RenderConfig
from win32_raytracer_tpu.parallel.shard import make_mesh, render_sharded
from win32_raytracer_tpu.render import render
from win32_raytracer_tpu.scene.builders import test_scene as make_test_scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene()


def test_mesh_construction(eight_devices):
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("tiles",)
    assert make_mesh(4).devices.size == 4


def test_rows_mode_assembles_full_image(scene, eight_devices):
    cfg = RenderConfig(width=64, height=48, samples=2, seed=11)
    mesh = make_mesh(8)
    img = render_sharded(scene, cfg=cfg, mesh=mesh, mode="rows")
    assert img.shape == (48, 64, 3)
    # Sky at the top; something else in the middle.
    assert img[0, 0, 2] > 200
    # Every row band rendered (no black stripes from bad stitching).
    assert (img.reshape(48, -1).max(axis=1) > 0).all()


def test_rows_mode_close_to_single_device(scene, eight_devices):
    """Same scene through the mesh vs one device: same image statistics.

    (Exact equality is not expected — chunk geometry differs, so the
    counter-based RNG assigns different draws.)"""
    cfg = RenderConfig(width=64, height=48, samples=16, seed=11)
    img_multi = render_sharded(scene, cfg=cfg, mesh=make_mesh(8), mode="rows")
    img_single = render(scene, cfg=cfg.replace(backend="jnp"))
    diff = np.abs(img_multi.astype(float) - img_single.astype(float))
    assert diff.mean() < 4.0, diff.mean()


def test_spp_mode_psum(scene, eight_devices):
    """Sample-sharded rendering with the cross-device pmean reduction."""
    cfg = RenderConfig(width=64, height=32, samples=16, seed=7)
    img = render_sharded(scene, cfg=cfg, mesh=make_mesh(8), mode="spp")
    assert img.shape == (32, 64, 3)
    img_single = render(scene, cfg=cfg.replace(backend="jnp"))
    diff = np.abs(img.astype(float) - img_single.astype(float))
    assert diff.mean() < 4.0, diff.mean()


def test_spp_mode_requires_divisibility(scene, eight_devices):
    cfg = RenderConfig(width=16, height=8, samples=3, seed=0)
    with pytest.raises(ValueError):
        render_sharded(scene, cfg=cfg, mesh=make_mesh(8), mode="spp")


def test_unknown_mode(scene, eight_devices):
    with pytest.raises(ValueError):
        render_sharded(scene, cfg=RenderConfig(width=8, height=8, samples=1),
                       mesh=make_mesh(2), mode="bogus")


def test_rows_mode_small_mesh(scene, eight_devices):
    """Works on a 2-device sub-mesh with a height that doesn't divide."""
    cfg = RenderConfig(width=32, height=23, samples=2, seed=3)
    img = render_sharded(scene, cfg=cfg, mesh=make_mesh(2), mode="rows")
    assert img.shape == (23, 32, 3)
