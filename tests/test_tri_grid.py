"""Triangle Morton-tile grid (tri_accel.py).

Exactness contract: the accelerated sweep must match the brute jnp
oracle (ops/hit_tri.hit_triangles) on every ray — the mask is
conservative, so only the cross-tile tie rule may differ (measure-zero;
these meshes have none)."""

import numpy as np
import pytest

import jax.numpy as jnp

from win32_raytracer_tpu.ops.hit_tri import hit_triangles
from win32_raytracer_tpu.scene.triangles import (
    box_mesh, build_triangle_scene, icosphere_mesh)
from win32_raytracer_tpu.ops.hit_tri import _T_IDX
from win32_raytracer_tpu.tri_accel import (
    build_tri_grid, hit_triangles_grid_jnp, hit_triangles_grid_rows_jnp,
    tri_block_mask_rows)


def _mesh(subdiv=3):
    v1, f1 = icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=subdiv)
    v2, f2 = box_mesh((2.0, 0.4, 0.5), (0.8, 0.8, 0.8))
    verts = np.concatenate([v1, v2], axis=0)
    faces = np.concatenate([f1, f2 + len(v1)], axis=0)
    return build_triangle_scene(verts, faces)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = np.asarray(rng.uniform(-4, 4, (3, n)), np.float32)
    d = np.asarray(rng.normal(size=(3, n)), np.float32)
    tm = np.zeros((1, n), np.float32)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)


def test_build_tri_grid_structure():
    scene = _mesh(3)  # 1292 active tris
    grid = build_tri_grid(scene, tile_rows=64)
    assert grid is not None
    assert grid.n_tiles == -(-int(np.asarray(scene.active).sum()) // 64)
    boxes = np.asarray(grid.tile_boxes)
    assert (boxes[:, 1] >= boxes[:, 0]).all()
    # Morton tiling keeps tiles spatially compact: the mean tile box
    # diagonal must be far below the scene diagonal.
    diag = np.linalg.norm(boxes[:, 1::2] - boxes[:, 0::2], axis=1)
    sbox = np.asarray(grid.scene_box)
    sdiag = np.linalg.norm(sbox[1::2] - sbox[0::2])
    assert diag.mean() < 0.45 * sdiag
    # every active triangle appears exactly once
    idxs = np.asarray(grid.tile_attrs)[:, _T_IDX]
    real = idxs[np.asarray(grid.tile_attrs)[:, 3:9].any(axis=1)]
    assert len(np.unique(real)) == int(np.asarray(scene.active).sum())


def test_small_mesh_declines():
    scene = _mesh(1)  # 92 tris: below min_tris
    assert build_tri_grid(scene) is None


def test_mask_is_conservative_and_grid_jnp_exact():
    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    o, d, tm = _rays(1024, seed=3)
    ref = hit_triangles(scene, np.asarray(o).T, np.asarray(d).T,
                        np.asarray(tm)[0])
    t_g, g = hit_triangles_grid_jnp(grid, o, d, tm, ray_block=256)
    ref_t = np.asarray(ref.t)
    got_t = np.asarray(t_g)[0]
    np.testing.assert_allclose(got_t, ref_t, rtol=1e-5)
    hit = np.asarray(ref.hit)
    got_idx = np.asarray(g)[_T_IDX]
    assert (got_idx[hit] == np.asarray(ref.idx)[hit]).all()


def test_mask_tightens_with_t_cap():
    """The mask is BLOCK-granular, so tightening shows on coherent rays
    (clustered origins, like primary blocks or post-compaction pixel
    neighborhoods), not on uniformly scattered ones."""
    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    rng = np.random.default_rng(5)
    n = 512
    o = jnp.asarray(np.float32(
        np.array([[4.0], [1.0], [0.0]])
        + rng.normal(0, 0.05, (3, n))))        # cluster right of the mesh
    d = jnp.asarray(np.float32(
        np.array([[-1.0], [0.0], [0.0]]) + rng.normal(0, 0.1, (3, n))))
    open_mask = tri_block_mask_rows(grid, o, d, None, 0.001, 256)
    # cap at t=0.2: segments end ~3.8 units before the icosphere
    capped = tri_block_mask_rows(
        grid, o, d, jnp.full((1, n), 0.2, jnp.float32), 0.001, 256)
    assert int(open_mask.sum()) > 0
    assert int(capped.sum()) < int(open_mask.sum())
    # capped mask is a subset of the open mask
    assert bool(((capped == 1) <= (open_mask == 1)).all())


def test_grid_rows_matches_oracle():
    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    o, d, tm = _rays(512, seed=7)
    ref = hit_triangles(scene, np.asarray(o).T, np.asarray(d).T,
                        np.asarray(tm)[0])
    rec = hit_triangles_grid_rows_jnp(grid, o, d, tm, ray_block=256)
    np.testing.assert_array_equal(np.asarray(rec.hit)[0],
                                  np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(rec.t)[0][hit],
                               np.asarray(ref.t)[hit], rtol=1e-5)
    assert (np.asarray(rec.idx)[0][hit] == np.asarray(ref.idx)[hit]).all()
    np.testing.assert_allclose(np.asarray(rec.normal)[:, hit],
                               np.asarray(ref.normal).T[:, hit],
                               rtol=1e-4, atol=1e-5)


def test_grid_kernel_t_cap_never_drops_nearer_hits():
    """With t_cap from a fake occluder pass, every tri hit NEARER than
    the cap must survive."""
    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    o, d, tm = _rays(512, seed=9)
    ref = hit_triangles(scene, np.asarray(o).T, np.asarray(d).T,
                        np.asarray(tm)[0])
    cap = jnp.full((1, 512), 2.0, jnp.float32)
    rec = hit_triangles_grid_rows_jnp(grid, o, d, tm, ray_block=256,
                                      t_cap=cap)
    ref_t = np.asarray(ref.t)
    near = np.asarray(ref.hit) & (ref_t < 2.0)
    np.testing.assert_allclose(np.asarray(rec.t)[0][near], ref_t[near],
                               rtol=1e-5)


@pytest.mark.parametrize("tile_rows", [128, 256])
def test_grid_coarse_tiles(tile_rows):
    """Tile granularity is a tuning knob (fewer, fatter tiles, coarser
    culling); the sweep must stay exact at coarser tiles than 64."""
    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=tile_rows)
    assert grid is not None and grid.tile_rows == tile_rows
    o, d, tm = _rays(512, seed=13)
    ref = hit_triangles(scene, np.asarray(o).T, np.asarray(d).T,
                        np.asarray(tm)[0])
    rec = hit_triangles_grid_rows_jnp(grid, o, d, tm, ray_block=256)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(rec.hit)[0], hit)
    np.testing.assert_allclose(np.asarray(rec.t)[0][hit],
                               np.asarray(ref.t)[hit], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(rec.idx)[0][hit],
                                  np.asarray(ref.idx)[hit])


def test_build_tri_grid_memoized():
    scene = _mesh(3)
    g1 = build_tri_grid(scene, tile_rows=64)
    g2 = build_tri_grid(scene, tile_rows=64)
    assert g1 is g2
    g3 = build_tri_grid(scene, tile_rows=128)
    assert g3 is not g1 and g3.tile_rows == 128


@pytest.mark.parametrize("ray_block", [128, 512])
def test_grid_kernel_ray_block_knob(ray_block):
    """Ray-block granularity is the other tuning axis (smaller blocks =
    tighter conservative masks); results must not depend on it.
    Exercises the segmentation math at non-default block sizes
    (cfg.tri_ray_block reaches the sweep via dispatch)."""
    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    o, d, tm = _rays(512, seed=17)
    ref = hit_triangles(scene, np.asarray(o).T, np.asarray(d).T,
                        np.asarray(tm)[0])
    rec = hit_triangles_grid_rows_jnp(grid, o, d, tm, ray_block=ray_block)
    np.testing.assert_array_equal(np.asarray(rec.hit)[0],
                                  np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(rec.t)[0][hit],
                               np.asarray(ref.t)[hit], rtol=1e-5)


def test_dispatch_tri_ray_block_keying():
    """cfg.tri_ray_block selects a distinct cached composite fn (hit fns
    are static jit args downstream, so same knob -> same object)."""
    from win32_raytracer_tpu.kernels.dispatch import _tri_grid_fn
    f_default = _tri_grid_fn(None, 0)
    f_512 = _tri_grid_fn(None, 512)
    f_2048 = _tri_grid_fn(None, 2048)
    assert f_default is _tri_grid_fn(None, 0)
    assert f_512 is _tri_grid_fn(None, 512)
    assert f_512 is not f_default
    assert f_2048 is not f_default  # explicit 2048 keys separately


def test_median_partition_exact_and_tighter():
    """The median-split partition (cfg.tri_partition='median') returns
    the same nearest hits as the Morton partition (tile membership only
    reshuffles which tile sweeps a triangle; the winner is partition-
    independent up to the cross-tile tie rule) and its tiles are no
    looser on average."""
    scene = _mesh(3)
    g_m = build_tri_grid(scene, tile_rows=64, partition="morton")
    g_s = build_tri_grid(scene, tile_rows=64, partition="median")
    assert g_s is not None and g_s.n_tiles == g_m.n_tiles
    # membership: every active triangle exactly once
    idxs = np.asarray(g_s.tile_attrs)[:, _T_IDX]
    real = idxs[np.asarray(g_s.tile_attrs)[:, 3:9].any(axis=1)]
    assert len(np.unique(real)) == int(np.asarray(scene.active).sum())

    o, d, tm = _rays(512, seed=11)
    t_m, _ = hit_triangles_grid_jnp(g_m, o, d, tm)
    t_s, _ = hit_triangles_grid_jnp(g_s, o, d, tm)
    np.testing.assert_allclose(np.asarray(t_s), np.asarray(t_m),
                               rtol=1e-6, atol=1e-6)

    diag_m = np.linalg.norm(np.asarray(g_m.tile_boxes)[:, 1::2]
                            - np.asarray(g_m.tile_boxes)[:, 0::2], axis=1)
    diag_s = np.linalg.norm(np.asarray(g_s.tile_boxes)[:, 1::2]
                            - np.asarray(g_s.tile_boxes)[:, 0::2], axis=1)
    assert diag_s.mean() <= diag_m.mean() * 1.02, (
        diag_s.mean(), diag_m.mean())


def test_sorted_tri_pass_matches_direct():
    """The two-phase working-set sort (kernels/tri_rebin.py) returns the
    SAME records as the direct call in the original lane order: the jnp
    sweep's winner is lane-order-independent (tile visit order is fixed
    and the mask is conservative), and the inverse-permutation sort
    restores lane positions exactly."""
    from win32_raytracer_tpu.kernels.tri_rebin import sorted_tri_pass
    from win32_raytracer_tpu.tri_accel import hit_triangles_grid_rows_jnp

    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    o, d, tm = _rays(640, seed=7)
    rng = np.random.default_rng(3)
    # t_cap mix: some tight (occluded), some +inf
    cap = np.where(rng.random(640) < 0.5, rng.uniform(0.1, 3.0, 640),
                   3.4e38).astype(np.float32)[None]

    def tri_fn(g, o2, d2, t2, min_t=0.001, t_cap=None):
        return hit_triangles_grid_rows_jnp(g, o2, d2, t2, min_t=min_t,
                                           t_cap=t_cap, ray_block=256)

    direct = tri_fn(grid, o, d, tm, t_cap=jnp.asarray(cap))
    sorted_ = sorted_tri_pass(tri_fn, grid, o, d, tm, jnp.asarray(cap))
    # t_cap only TIGHTENS the mask; hits beyond the cap are legal output
    # (combine_hits_rows discards them: strict b.t < a.t with a.t=cap),
    # and the no-touch packing legitimately turns them into misses.
    # Parity contract is therefore the EFFECTIVE record: identical
    # wherever the hit survives the cap; otherwise both arms must be
    # post-combine dead (miss, or t >= cap).
    dt, st_ = np.asarray(direct.t[0]), np.asarray(sorted_.t[0])
    live_d = np.asarray(direct.hit[0]) & (dt < cap[0])
    live_s = np.asarray(sorted_.hit[0]) & (st_ < cap[0])
    np.testing.assert_array_equal(live_d, live_s)
    assert live_d.any()  # the comparison is not vacuous
    for f, a, b in zip(direct._fields, direct, sorted_):
        np.testing.assert_array_equal(np.asarray(a)[:, live_d],
                                      np.asarray(b)[:, live_d],
                                      err_msg=f)


def test_tri_rebin_render_matches_off_exactly():
    """tri_rebin='on' never permutes the path state, so the render is
    exactly the rebin-off image (unlike driver-level binning, which
    permutes lanes and only matches statistically).  Both arms run the
    host loop (rebin needs it), so they compile the same step programs."""
    from win32_raytracer_tpu.persistent import render_image_persistent
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.scene.builders import mesh_scene

    scene = mesh_scene(subdivisions=3)
    cfg = RenderConfig(width=32, height=16, samples=8, seed=5,
                       backend="jnp", accel="grid", ray_binning="off",
                       one_shot="off")
    base = np.asarray(render_image_persistent(scene, None, cfg))
    reb = np.asarray(render_image_persistent(
        scene, None, cfg.replace(tri_rebin="on")))
    np.testing.assert_array_equal(reb, base)


def test_dda_tri_pass_matches_direct():
    """The DDA macro-cell expansion (kernels/tri_dda.py) returns the
    same EFFECTIVE records as the direct pass: every hit surviving the
    occlusion cap is found by one of the lane's cell pairs (the pair
    windows tile the capped chord; overflow lanes fall back to one
    full-segment pair), with t agreeing to float round-off (slot>=1
    origins shift to the interval start)."""
    from win32_raytracer_tpu.kernels.tri_dda import dda_tri_pass
    from win32_raytracer_tpu.tri_accel import hit_triangles_grid_rows_jnp

    scene = _mesh(3)
    grid = build_tri_grid(scene, tile_rows=64)
    o, d, tm = _rays(640, seed=7)
    rng = np.random.default_rng(3)
    cap = np.where(rng.random(640) < 0.5, rng.uniform(0.1, 3.0, 640),
                   3.4e38).astype(np.float32)[None]

    def tri_fn(g, o2, d2, t2, min_t=0.001, t_cap=None):
        return hit_triangles_grid_rows_jnp(g, o2, d2, t2, min_t=min_t,
                                           t_cap=t_cap, ray_block=256)

    direct = tri_fn(grid, o, d, tm, t_cap=jnp.asarray(cap))
    dda = dda_tri_pass(tri_fn, grid, o, d, tm, jnp.asarray(cap),
                       g_cells=8, k_max=4)
    dt, st_ = np.asarray(direct.t[0]), np.asarray(dda.t[0])
    live_d = np.asarray(direct.hit[0]) & (dt < cap[0])
    live_s = np.asarray(dda.hit[0]) & (st_ < cap[0])
    np.testing.assert_array_equal(live_d, live_s)
    assert live_d.any()
    np.testing.assert_allclose(st_[live_d], dt[live_d], rtol=2e-5,
                               atol=2e-5)
    # winning geometry identical where the hit is unambiguous
    np.testing.assert_array_equal(np.asarray(dda.idx[0])[live_d],
                                  np.asarray(direct.idx[0])[live_d])
    np.testing.assert_array_equal(np.asarray(dda.mat_id[0])[live_d],
                                  np.asarray(direct.mat_id[0])[live_d])


def test_tri_dda_render_matches_off():
    """tri_rebin='dda' renders match the rebin-off image to float
    round-off (slot>=1 pair origins shift by the interval offset, so
    per-lane t/point can differ in last ulps — unlike 'on', which is
    bitwise)."""
    from win32_raytracer_tpu.persistent import render_image_persistent
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.scene.builders import mesh_scene

    scene = mesh_scene(subdivisions=3)
    cfg = RenderConfig(width=32, height=16, samples=8, seed=5,
                       backend="jnp", accel="grid", ray_binning="off")
    base = np.asarray(render_image_persistent(scene, None, cfg),
                      np.float32)
    dda = np.asarray(render_image_persistent(
        scene, None, cfg.replace(tri_rebin="dda")), np.float32)
    diff = np.abs(np.sqrt(np.clip(dda, 0, 1))
                  - np.sqrt(np.clip(base, 0, 1)))
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 8 / 255).mean() < 0.01, (diff > 8 / 255).mean()
    # cfg.tri_dda_k overrides the kernel's pair-slot count (K=12 is the
    # sim winner); the render stays within the same round-off envelope.
    k12 = np.asarray(render_image_persistent(
        scene, None, cfg.replace(tri_rebin="dda", tri_dda_k=12)),
        np.float32)
    diff = np.abs(np.sqrt(np.clip(k12, 0, 1))
                  - np.sqrt(np.clip(base, 0, 1)))
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 8 / 255).mean() < 0.01, (diff > 8 / 255).mean()


def test_tri_knob_validation():
    """Bad tri_rebin / tri_dda_k values raise instead of silently
    running the production path (an unvalidated 'ON' typo used to
    behave as 'off' with driver binning still active)."""
    from win32_raytracer_tpu.config import RenderConfig
    from win32_raytracer_tpu.kernels.dispatch import get_hit_fn_rows_accel

    scene = _mesh(3)
    cfg = RenderConfig(width=32, height=16, samples=4, backend="jnp",
                       accel="grid", tri_rebin="ON")
    with pytest.raises(ValueError, match="tri_rebin"):
        get_hit_fn_rows_accel(cfg, scene, None)
    cfg2 = RenderConfig(width=32, height=16, samples=4, backend="jnp",
                        accel="grid", tri_dda_k=-1)
    with pytest.raises(ValueError, match="tri_dda_k"):
        get_hit_fn_rows_accel(cfg2, scene, None)
