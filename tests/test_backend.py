"""Backend resolution (kernels/dispatch.py) and compile-cache placement
(_cache.py)."""

import os

import pytest

import jax

from win32_raytracer_tpu import _cache
from win32_raytracer_tpu.config import RenderConfig
from win32_raytracer_tpu.kernels import dispatch
from win32_raytracer_tpu.kernels.hit_triton import hit_spheres_triton
from win32_raytracer_tpu.ops.hit import hit_spheres
from win32_raytracer_tpu.scene.builders import get_scene


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "gpu", "pallas"),
    ("auto", "cpu", "jnp"),
    ("pallas", "gpu", "pallas"),
    ("jnp", "gpu", "jnp"),
    ("jnp", "cpu", "jnp"),
])
def test_resolve_backend(backend, platform, want):
    cfg = RenderConfig(backend=backend)
    assert dispatch.resolve_backend(cfg, platform) == want


@pytest.mark.parametrize("backend,platform,match", [
    ("auto", "metal", "no hit backend"),
    ("auto", "rocm", "no hit backend"),
    ("pallas", "cpu", "needs a GPU"),
    ("mosaic", "gpu", "unknown backend"),
])
def test_resolve_backend_refuses(backend, platform, match):
    with pytest.raises(ValueError, match=match):
        dispatch.resolve_backend(RenderConfig(backend=backend), platform)


def test_default_platform_is_the_cpu_pin():
    """Under the test CPU pin, "auto" resolves to the plain sweep without
    an explicit platform, and an explicit kernel request is refused."""
    assert dispatch.resolve_backend(RenderConfig()) == "jnp"
    with pytest.raises(ValueError, match="needs a GPU"):
        dispatch.get_hit_fn_rows(RenderConfig(backend="pallas"))


def test_hit_fn_choice_follows_platform():
    cfg = RenderConfig()
    scene = get_scene("test")
    assert dispatch.get_hit_fn_rows(cfg, scene, "gpu") is hit_spheres_triton
    assert dispatch.get_hit_fn(cfg, scene, "cpu") is hit_spheres
    # Column form of the kernel: cached, so jit sees one static argument.
    col = dispatch.get_hit_fn(cfg, scene, "gpu")
    assert col is dispatch.get_hit_fn(cfg, scene, "gpu")
    assert col is not hit_spheres


def test_sphere_grid_refused():
    """accel='grid' has no sphere path and says so."""
    with pytest.raises(ValueError, match="sphere scenes have no grid"):
        dispatch.get_hit_fn_rows_accel(RenderConfig(accel="grid"),
                                       get_scene("final"), None)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert _cache.cache_dir() == str(tmp_path / "c")


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _cache.cache_dir() == os.path.join(root, ".jax_cache")
    assert _cache.cache_dir() == _cache.DEFAULT_DIR


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    target = tmp_path / "jc"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    try:
        got = _cache.enable_compile_cache(min_compile_secs=0.5)
        assert got == str(target) and target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


def test_composite_scene_on_gpu_uses_kernel_for_spheres():
    """Composite scenes on a GPU: the kernel (through its column wrapper)
    for the spheres, the plain triangle sweep, one cached function."""
    from win32_raytracer_tpu.scene.builders import mesh_scene

    scene = mesh_scene()
    f = dispatch.get_hit_fn_rows(RenderConfig(), scene, "gpu")
    assert f is dispatch.get_hit_fn_rows(RenderConfig(), scene, "gpu")
    assert f is not dispatch.get_hit_fn_rows(RenderConfig(), scene, "cpu")


def test_triangle_grid_keeps_platform_sphere_pass():
    """accel='grid' on a composite mesh: the grid sweep for triangles and
    the platform's sphere pass (kernel on a GPU, plain sweep on a CPU)."""
    from win32_raytracer_tpu.scene.builders import mesh_scene
    from win32_raytracer_tpu.tri_accel import TriGridScene

    scene = mesh_scene(subdivisions=3)
    cfg = RenderConfig(accel="grid")
    sc_g, f_g = dispatch.get_hit_fn_rows_accel(cfg, scene, None, "gpu")
    sc_c, f_c = dispatch.get_hit_fn_rows_accel(cfg, scene, None, "cpu")
    assert isinstance(sc_g.triangles, TriGridScene)
    assert f_g is not f_c
    assert f_g is dispatch._tri_grid_fn(hit_spheres_triton, 0,
                                        rebin="off", dda_k=0)
