"""Hit-function selection.

``cfg.backend`` names the sphere sweep:

* ``"pallas"``: the Triton kernel of kernels/hit_triton.py, GPU only;
* ``"jnp"``: the plain XLA sweep of ops/hit.py, on any platform — also
  the reference the kernel is tested against;
* ``"auto"``: by the platform of the devices the render runs on,
  ``"gpu"`` to the measured winner (``_AUTO``) and ``"cpu"`` to jnp.
  Any other platform raises.

Triangles always take the plain XLA sweeps (ops/hit_tri.py brute force,
or tri_accel's grid sweep for ``accel="grid"``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops.hit import HitRecord, hit_spheres as hit_spheres_jnp
from ..ops.rows import hit_rows_adapter
from .hit_triton import hit_spheres_triton

# "auto" per platform: the sphere kernel measured faster end to end on an
# H100 (PERF.md, "Sphere-hit kernel").
_AUTO = {"gpu": "pallas", "cpu": "jnp"}


@functools.lru_cache(maxsize=None)
def _default_platform() -> str:
    return jax.devices()[0].platform


def resolve_backend(cfg: RenderConfig, platform=None) -> str:
    """``cfg.backend`` -> "pallas" | "jnp" for ``platform`` (default: the
    default device's).  Sharded paths pass their mesh devices' platform.
    A request the platform cannot serve raises; nothing falls back."""
    plat = platform or _default_platform()
    if cfg.backend == "auto":
        if plat not in _AUTO:
            raise ValueError(f"no hit backend for platform {plat!r} "
                             f"(supported: {', '.join(sorted(_AUTO))})")
        return _AUTO[plat]
    if cfg.backend == "pallas":
        if plat != "gpu":
            raise ValueError("backend='pallas' runs the GPU kernel and "
                             f"needs a GPU device (platform {plat!r})")
        return "pallas"
    if cfg.backend == "jnp":
        return "jnp"
    raise ValueError(f"unknown backend {cfg.backend!r} (use auto|pallas|jnp)")


@functools.lru_cache(maxsize=None)
def _columns(rows_fn):
    """Column-layout (ops.hit signature) wrapper of a rows hit function.
    Cached: hit functions are static jit arguments downstream."""
    def column_fn(scene, o, d, t, min_t=0.001):
        rec = rows_fn(scene, o.T, d.T, t[None], min_t=min_t)
        return HitRecord(
            hit=rec.hit[0], t=rec.t[0], point=rec.point.T,
            normal=rec.normal.T, idx=rec.idx[0], mat_id=rec.mat_id[0],
            albedo=rec.albedo.T, fuzz=rec.fuzz[0], ior=rec.ior[0])
    return column_fn


def get_hit_fn(cfg: RenderConfig, scene=None, platform=None):
    """Column-layout hit function for ``cfg.backend``.  With ``scene``
    given it also handles triangle and composite scenes (spheres on the
    selected backend, triangles on the jnp sweep)."""
    if resolve_backend(cfg, platform) == "pallas":
        sphere_fn = _columns(hit_spheres_triton)
    else:
        sphere_fn = hit_spheres_jnp
    if scene is None:
        return sphere_fn
    from ..scene.composite import make_hit_fn
    return make_hit_fn(scene, sphere_fn)


def get_hit_fn_rows(cfg: RenderConfig, scene=None, platform=None):
    """Rows-layout hit function (ops/rows.py interface) for the persistent
    scheduler: the kernel itself for plain sphere scenes on "pallas",
    otherwise the column function behind the cached rows adapter."""
    from ..scene.spheres import SphereScene

    if (resolve_backend(cfg, platform) == "pallas"
            and (scene is None or isinstance(scene, SphereScene))):
        return hit_spheres_triton
    return hit_rows_adapter(get_hit_fn(cfg, scene, platform))


def _make_tri_pass(kernel, rb, rebin, dda_k):
    """Triangle-pass wrapper over the grid sweep ``kernel``: three-way
    branch between the plain sweep, the occlusion-capped working-set
    sort (kernels/tri_rebin.py), and DDA macro-cell expansion
    (kernels/tri_dda.py)."""
    def tf(g, o2, d2, t2, min_t=0.001, t_cap=None):
        return kernel(g, o2, d2, t2, min_t=min_t, t_cap=t_cap, ray_block=rb)

    def tri_pass(grid, o, d, t, min_t, t_cap):
        if rebin in ("on", "dda"):
            if t_cap is None:
                t_cap = jnp.full_like(o[:1], np.float32(3.4e38))
            if rebin == "dda":
                from .tri_dda import dda_tri_pass
                kw = {"k_max": dda_k} if dda_k else {}
                return dda_tri_pass(tf, grid, o, d, t, t_cap,
                                    min_t=min_t, **kw)
            from .tri_rebin import sorted_tri_pass
            return sorted_tri_pass(tf, grid, o, d, t, t_cap, min_t=min_t)
        return tf(grid, o, d, t, min_t=min_t, t_cap=t_cap)
    return tri_pass


@functools.lru_cache(maxsize=16)
def _tri_grid_fn(sphere_fn, ray_block=0, rebin="off", dda_k=0):
    """Rows hit fn for scenes whose triangle side carries a TriGridScene:
    the grid sweep (tri_accel.hit_triangles_grid_rows_jnp), with the
    sphere pass (if any) run first and its nearest t capping the
    triangle segments — a sphere hit occludes every farther tile.
    Cached: hit fns are static jit args downstream."""
    from ..ops.rows import combine_hits_rows
    from ..tri_accel import TriGridScene, hit_triangles_grid_rows_jnp

    tri_pass = _make_tri_pass(hit_triangles_grid_rows_jnp,
                              ray_block or 512, rebin, dda_k)

    def composite(sc, o, d, t, min_t=0.001):
        if isinstance(sc, TriGridScene):
            return tri_pass(sc, o, d, t, min_t, None)
        if sc.spheres is None:
            return tri_pass(sc.triangles, o, d, t, min_t, None)
        rec = sphere_fn(sc.spheres, o, d, t, min_t=min_t)
        rec_t = tri_pass(sc.triangles, o, d, t, min_t, rec.t)
        return combine_hits_rows(rec, rec_t,
                                 idx_offset_b=sc.spheres.padded_size)
    return composite


def get_hit_fn_rows_accel(cfg: RenderConfig, scene, cam, platform=None):
    """Resolve (scene, rows hit fn) with the acceleration structure.

    ``cfg.accel == "grid"`` on a mesh of at least
    tri_accel.build_tri_grid's ``min_tris`` triangles swaps the triangle
    side for its Morton-tiled grid and sweeps it with the grid pass;
    "auto" and "off" keep the brute sweeps.  The sphere side has no grid
    path: ``accel="grid"`` on a plain sphere scene raises.  ``platform``
    is the platform of the devices the render runs on (see
    resolve_backend)."""
    from ..scene.composite import CompositeScene
    from ..scene.triangles import TriangleScene

    if cfg.tri_rebin not in ("auto", "on", "dda", "off"):
        raise ValueError(
            f"tri_rebin must be auto|on|dda|off, got {cfg.tri_rebin!r}")
    if cfg.tri_dda_k < 0:
        raise ValueError(
            f"tri_dda_k must be >= 0 (0 = kernel default), got "
            f"{cfg.tri_dda_k}")
    if cfg.accel not in ("auto", "grid", "off"):
        raise ValueError(f"accel must be auto|grid|off, got {cfg.accel!r}")

    if cfg.accel == "grid":
        tri = (scene if isinstance(scene, TriangleScene)
               else scene.triangles
               if isinstance(scene, CompositeScene) else None)
        if tri is not None:
            from ..tri_accel import build_tri_grid
            part = ("morton" if cfg.tri_partition == "auto"
                    else cfg.tri_partition)
            grid = (build_tri_grid(tri, tile_rows=cfg.tri_tile_rows,
                                   partition=part)
                    if cfg.tri_tile_rows
                    else build_tri_grid(tri, partition=part))
            if grid is not None:
                has_spheres = (isinstance(scene, CompositeScene)
                               and scene.spheres is not None)
                new_scene = (scene._replace(triangles=grid)
                             if has_spheres else grid)
                sphere_fn = get_hit_fn_rows(cfg, None, platform)
                return new_scene, _tri_grid_fn(
                    sphere_fn, cfg.tri_ray_block,
                    rebin="off" if cfg.tri_rebin == "auto"
                    else cfg.tri_rebin, dda_k=cfg.tri_dda_k)
        raise ValueError(
            "accel='grid' needs a mesh with enough triangles "
            "(tri_accel.build_tri_grid); sphere scenes have no grid path")
    return scene, get_hit_fn_rows(cfg, scene, platform)
