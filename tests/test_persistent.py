"""Persistent-wavefront scheduler vs the fixed-depth wavefront."""

import numpy as np
import pytest

import jax.numpy as jnp

from win32_raytracer_tpu.config import RenderConfig
from win32_raytracer_tpu.persistent import render_image_persistent
from win32_raytracer_tpu.render import render, render_image, tonemap
from win32_raytracer_tpu.scene.builders import test_scene as make_test_scene


def test_persistent_matches_wavefront_statistically():
    """Same scene, same distributions, different schedulers: images agree
    within Monte-Carlo noise."""
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=32, seed=9, backend="jnp")
    img_w = np.asarray(tonemap(render_image(scene, None, cfg)))
    img_p = np.asarray(tonemap(render_image_persistent(scene, None, cfg)))
    diff = np.abs(img_w.astype(float) - img_p.astype(float))
    assert diff.mean() < 4.0, diff.mean()


def test_persistent_sample_accounting():
    """Every lane completes exactly spp samples (radiance averaged once)."""
    scene = make_test_scene()
    # Sky-only view: point the camera up so every sample = 1 bounce (miss).
    from win32_raytracer_tpu.scene.camera import make_camera
    cam = make_camera((0, 50, 0), (0, 51, 0), (1, 0, 0), 60.0, 2.0, 0.0, 1.0)
    cfg = RenderConfig(width=32, height=16, samples=7, seed=1, backend="jnp")
    lin = np.asarray(render_image_persistent(scene, cam, cfg))
    # All-sky image: each pixel is the average of 7 sky draws; values must
    # lie inside the sky gradient's range with no accumulation error.
    assert lin.min() >= 0.5 - 1e-5 and lin.max() <= 1.0 + 1e-5
    # Compare against wavefront for the same camera: identical statistics.
    lin_w = np.asarray(render_image(scene, cam, cfg))
    assert np.abs(lin - lin_w).mean() < 0.02


def test_compact_receiver_redistribution_conserves_samples():
    """_compact with n_receivers: per-pixel remaining-sample totals and
    radiance are conserved exactly; receivers are dead lanes that adopted
    donor pixels with sample=-1."""
    import jax.numpy as jnp
    from win32_raytracer_tpu.persistent import PathState, _compact

    rng = np.random.default_rng(7)
    n, kpp, quota = 4096, 4, 25
    hw = n // kpp
    alive = rng.uniform(size=n) < 0.4
    sample = rng.integers(0, quota, n).astype(np.int32)
    sample[~alive] = quota - 1  # dead lanes exhausted their quota
    st = PathState(
        origin=jnp.asarray(rng.normal(size=(3, n)), jnp.float32),
        direction=jnp.asarray(rng.normal(size=(3, n)), jnp.float32),
        time=jnp.zeros((1, n), jnp.float32),
        throughput=jnp.ones((3, n), jnp.float32),
        radiance_sum=jnp.asarray(rng.uniform(size=(3, n)), jnp.float32),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.asarray(sample[None]),
        pixel=jnp.arange(n, dtype=jnp.int32)[None],
        path_alive=jnp.asarray(alive[None]),
        s_base=jnp.asarray((np.arange(n) % kpp * quota)[None], jnp.int32),
        s_quota=jnp.full((1, n), quota, jnp.int32),
    )
    accum = jnp.zeros((3, hw), jnp.float32)
    k_new, n_recv = 3072, 1024

    def remaining_per_pixel(stt):
        # unstarted samples after the current one, per pixel
        rem = np.maximum(
            np.asarray(stt.s_quota[0]) - 1 - np.asarray(stt.sample[0]), 0)
        out = np.zeros(hw)
        np.add.at(out, np.asarray(stt.pixel[0]) // kpp, rem)
        return out

    before = remaining_per_pixel(st)
    new, acc = _compact(st, accum, k_new=k_new, lanes_per_pixel=kpp,
                        tail_sorted=True, n_receivers=n_recv)
    after = remaining_per_pixel(new)
    np.testing.assert_array_equal(after, before)
    # radiance conservation: accum + surviving radiance == original total
    tot0 = float(np.asarray(st.radiance_sum).sum())
    tot1 = float(np.asarray(acc).sum() + np.asarray(new.radiance_sum).sum())
    np.testing.assert_allclose(tot1, tot0, rtol=1e-5)
    # receivers: dead, fresh, and their radiance rows are zeroed
    r0 = k_new - n_recv
    assert not np.asarray(new.path_alive[0, r0:]).any()
    assert (np.asarray(new.sample[0, r0:]) == -1).all()
    assert (np.asarray(new.radiance_sum[:, r0:]) == 0.0).all()
    # at 40% alive there IS real work to adopt
    assert int(np.asarray(new.s_quota[0, r0:]).sum()) > 0


def test_persistent_render_with_redistribution_statistics():
    """End-to-end render with receivers active at tiny thresholds must
    match the wavefront render statistically."""
    import win32_raytracer_tpu.persistent as P

    scene = make_test_scene()
    cfg = RenderConfig(width=32, height=16, samples=32, seed=3,
                       backend="jnp", rays_per_chunk=1 << 13,
                       redistribute="on")
    old_floor, old_min = P._COMPACT_FLOOR, P._RECV_MIN
    try:
        P._COMPACT_FLOOR = 256   # force the above-floor path at toy sizes
        P._RECV_MIN = 64
        lin = np.asarray(render_image_persistent(scene, None, cfg))
    finally:
        P._COMPACT_FLOOR, P._RECV_MIN = old_floor, old_min
    lin_w = np.asarray(render_image(scene, None, cfg))
    assert np.isfinite(lin).all()
    assert np.abs(lin - lin_w).mean() < 0.03


def test_redistribute_defaults_off():
    """redistribute='auto' must resolve to OFF: only an explicit 'on'
    takes the overshoot path."""
    assert RenderConfig().redistribute == "auto"
    # The driver gates on the literal string 'on'; 'auto' must not match.
    import inspect
    import win32_raytracer_tpu.persistent as P
    src = inspect.getsource(P.render_image_persistent)
    assert 'cfg.redistribute == "on"' in src


def test_persistent_scheduler_selected_by_auto():
    scene = make_test_scene()
    cfg = RenderConfig(width=32, height=16, samples=16, seed=2,
                       backend="jnp", scheduler="auto")
    img = render(scene, cfg=cfg)
    assert img.shape == (16, 32, 3)
    cfg2 = cfg.replace(scheduler="persistent")
    img2 = render(scene, cfg=cfg2)
    np.testing.assert_array_equal(img, img2)


def test_stratified_sampling_reduces_variance():
    """Stratified pixel jitter should not change the mean image and should
    not increase noise (weak check: images stay close)."""
    scene = make_test_scene()
    base = RenderConfig(width=48, height=24, samples=16, seed=3,
                        backend="jnp", scheduler="persistent")
    img_u = render(scene, cfg=base)
    img_s = render(scene, cfg=base.replace(stratify=True))
    diff = np.abs(img_u.astype(float) - img_s.astype(float))
    assert diff.mean() < 4.0, diff.mean()


def test_bin_sort_spatial_key_and_conservation():
    """_bin_sort permutes lanes into (Morton cell, octant) buckets with
    dead lanes parked at the end; every per-lane tuple is conserved."""
    import win32_raytracer_tpu.persistent as P

    rng = np.random.default_rng(5)
    n = 1024
    o = rng.uniform(-1.0, 3.0, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    alive = rng.random(n) > 0.3
    st = P.PathState(
        origin=jnp.asarray(o), direction=jnp.asarray(d),
        time=jnp.zeros((1, n), jnp.float32),
        throughput=jnp.ones((3, n), jnp.float32),
        radiance_sum=jnp.asarray(rng.random((3, n)).astype(np.float32)),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.zeros((1, n), jnp.int32),
        pixel=jnp.asarray(rng.permutation(n).astype(np.int32))[None],
        path_alive=jnp.asarray(alive)[None],
        s_base=jnp.zeros((1, n), jnp.int32),
        s_quota=jnp.asarray(rng.integers(0, 9, n).astype(np.int32))[None],
    )
    box = (0.0, 0.0, 0.0, 0.5, 0.5, 0.5)  # lo=(0,0,0), extent 2 per axis
    out = P._bin_sort(st, box=box)

    a_out = np.asarray(out.path_alive[0])
    n_alive = int(alive.sum())
    # Dead lanes sort to the end and are parked outside every AABB.
    assert a_out[:n_alive].all() and not a_out[n_alive:].any()
    assert (np.asarray(out.origin[1, n_alive:]) == -1e9).all()
    assert (np.asarray(out.direction[2, n_alive:]) == 1.0).all()

    # Alive lanes: keys ascending (recomputed from the sorted state,
    # replicating whichever variant _BIN_KEY selects).
    oo = np.asarray(out.origin[:, :n_alive])
    dd = np.asarray(out.direction[:, :n_alive])

    def spread3(v):
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)

    def cells(p, n_c):
        return [np.clip(((p[ax].astype(np.float32) - np.float32(box[ax]))
                         * np.float32(box[3 + ax] * n_c))
                        .astype(np.int64), 0, n_c - 1) for ax in range(3)]

    def morton(cs):
        return spread3(cs[0]) | (spread3(cs[1]) << 1) | (spread3(cs[2]) << 2)

    octant = ((dd[0] < 0) | ((dd[1] < 0) << 1) | ((dd[2] < 0) << 2))
    if P._BIN_KEY == "pos4+exit4+oct":
        # f32 throughout — must reproduce the kernel's arithmetic bit
        # for bit or edge-of-cell lanes produce spurious key mismatches.
        eps = np.float32(1e-12)
        hi_t = np.full(n_alive, 1e8, np.float32)
        for ax in range(3):
            dn = np.where(np.abs(dd[ax]) < eps,
                          np.where(dd[ax] < 0, -eps, eps),
                          dd[ax]).astype(np.float32)
            lo_p = np.float32(box[ax])
            hi_p = np.float32(box[ax] + 1.0 / box[3 + ax])
            ta = ((lo_p - oo[ax]) / dn).astype(np.float32)
            tb = ((hi_p - oo[ax]) / dn).astype(np.float32)
            hi_t = np.minimum(hi_t, np.maximum(ta, tb))
        hi_t = np.maximum(hi_t, np.float32(0.0))
        exit_p = [(oo[ax] + hi_t * dd[ax]).astype(np.float32)
                  for ax in range(3)]
        key = ((morton(cells(oo, 4)) << 9)
               | (morton(cells(exit_p, 4)) << 3) | octant)
    else:
        key = (morton(cells(oo, P._BIN_CELLS)) << 3) | octant
    assert (np.diff(key) >= 0).all()

    # Per-lane payload conservation (multiset equality over id tuples).
    def tuples(s, sel):
        return sorted(zip(np.asarray(s.pixel[0])[sel],
                          np.asarray(s.s_quota[0])[sel],
                          np.asarray(s.radiance_sum[0])[sel]))
    assert tuples(st, slice(None)) == tuples(out, slice(None))
    # Alive lanes keep their rays bit-for-bit (match via pixel id).
    in_by_pix = {int(p): i for i, p in enumerate(np.asarray(st.pixel[0]))}
    for j in range(n_alive):
        i = in_by_pix[int(np.asarray(out.pixel[0])[j])]
        assert (np.asarray(st.origin[:, i]) == oo[:, j]).all()
        assert (np.asarray(st.direction[:, i]) == dd[:, j]).all()


def test_ray_binning_on_requires_grid_scene():
    import pytest

    scene = make_test_scene()
    cfg = RenderConfig(width=16, height=8, samples=8, seed=1,
                       backend="jnp", ray_binning="on")
    with pytest.raises(ValueError, match="ray_binning"):
        render_image_persistent(scene, None, cfg)


def test_binned_grid_render_jnp_backend():
    """accel='grid' on the jnp backend runs the pure-jnp tri-grid sweep
    AND auto-enables ray binning (bin_box from the TriGridScene), so the
    full binned driver path is CPU-CI-covered.  Binning permutes lanes
    (different RNG streams), so parity with the unbinned arm is
    statistical, like a different compaction cadence."""
    from win32_raytracer_tpu.scene.builders import mesh_scene
    from win32_raytracer_tpu.tri_accel import TriGridScene

    scene = mesh_scene(subdivisions=3)  # ~1292 tris >= build min_tris
    cfg = RenderConfig(width=32, height=16, samples=8, seed=5,
                       backend="jnp", accel="grid")
    # The accel resolution itself must produce a TriGridScene composite.
    from win32_raytracer_tpu.kernels.dispatch import get_hit_fn_rows_accel
    sc2, _ = get_hit_fn_rows_accel(cfg, scene, None)
    assert isinstance(sc2.triangles, TriGridScene)

    binned = np.asarray(render_image_persistent(scene, None, cfg))
    off = np.asarray(render_image_persistent(
        scene, None, cfg.replace(ray_binning="off")))
    assert binned.shape == off.shape == (16, 32, 3)
    d = np.abs(np.sqrt(np.clip(binned, 0, 1)) - np.sqrt(np.clip(off, 0, 1)))
    assert d.mean() < 0.04, d.mean()


def test_one_shot_bitwise_equals_sequential_steps():
    """p_render_oneshot is max_steps successive p_bounce_step dispatches
    in one device-side while_loop: identical state, bit for bit."""
    import jax.numpy as jnp
    from win32_raytracer_tpu.persistent import (
        PathState, p_bounce_step, p_render_oneshot, p_respawn_step,
        _resolve_kpp)
    from win32_raytracer_tpu.kernels.dispatch import get_hit_fn_rows_accel
    from win32_raytracer_tpu.scene.camera import default_camera

    scene = make_test_scene()
    w, h, spp = 32, 16, 8
    cfg = RenderConfig(width=w, height=h, samples=spp, seed=4,
                       backend="jnp")
    scene, hit_fn = get_hit_fn_rows_accel(cfg, scene, None)
    cam = default_camera(w, h)
    kpp = _resolve_kpp(cfg, spp)
    quota = spp // kpp
    n = w * h * kpp
    st0 = PathState(
        origin=jnp.zeros((3, n), jnp.float32),
        direction=jnp.zeros((3, n), jnp.float32).at[2, :].set(1.0),
        time=jnp.zeros((1, n), jnp.float32),
        throughput=jnp.ones((3, n), jnp.float32),
        radiance_sum=jnp.zeros((3, n), jnp.float32),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.full((1, n), -1, jnp.int32),
        pixel=jnp.arange(n, dtype=jnp.int32)[None],
        path_alive=jnp.zeros((1, n), bool),
        s_base=(jnp.arange(n, dtype=jnp.int32) % kpp * quota)[None],
        s_quota=jnp.full((1, n), quota, jnp.int32),
    )
    salt = np.uint32(0xBEEF)
    from win32_raytracer_tpu.persistent import make_dims, step_cfg
    dims = make_dims(cfg, w, h, spp, kpp)
    kw = dict(cfg=step_cfg(cfg), hit_fn=hit_fn)
    st0 = p_respawn_step(cam, st0, salt, jnp.int32(0), dims,
                         cfg=step_cfg(cfg))
    max_steps = (quota + 1) * (cfg.max_depth + 2)

    one = p_render_oneshot(scene, cam, st0, salt, jnp.int32(0), dims,
                           jnp.int32(max_steps), **kw)

    seq = st0
    for step in range(1, max_steps + 1):
        seq = p_bounce_step(scene, cam, seq, salt, jnp.int32(step), dims,
                            **kw)
        if not bool(jnp.any(seq.path_alive)):
            break

    assert not bool(jnp.any(one.path_alive))
    for name, a, b in zip(PathState._fields, one, seq):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_render_until_bitwise_matches_sequential_and_target_exit():
    """p_render_until is successive p_bounce_step dispatches that stop
    at the FIRST step whose post-step alive count is <= alive_target
    (do-while: >= 1 step always runs): identical state, bit for bit,
    and the returned step/count match the manual loop's exit point."""
    import jax.numpy as jnp
    from win32_raytracer_tpu.persistent import (
        PathState, p_bounce_step, p_render_until, p_respawn_step,
        _resolve_kpp)
    from win32_raytracer_tpu.kernels.dispatch import get_hit_fn_rows_accel
    from win32_raytracer_tpu.scene.camera import default_camera

    scene = make_test_scene()
    w, h, spp = 32, 16, 8
    cfg = RenderConfig(width=w, height=h, samples=spp, seed=4,
                       backend="jnp")
    scene, hit_fn = get_hit_fn_rows_accel(cfg, scene, None)
    cam = default_camera(w, h)
    kpp = _resolve_kpp(cfg, spp)
    quota = spp // kpp
    n = w * h * kpp
    st0 = PathState(
        origin=jnp.zeros((3, n), jnp.float32),
        direction=jnp.zeros((3, n), jnp.float32).at[2, :].set(1.0),
        time=jnp.zeros((1, n), jnp.float32),
        throughput=jnp.ones((3, n), jnp.float32),
        radiance_sum=jnp.zeros((3, n), jnp.float32),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.full((1, n), -1, jnp.int32),
        pixel=jnp.arange(n, dtype=jnp.int32)[None],
        path_alive=jnp.zeros((1, n), bool),
        s_base=(jnp.arange(n, dtype=jnp.int32) % kpp * quota)[None],
        s_quota=jnp.full((1, n), quota, jnp.int32),
    )
    salt = np.uint32(0xBEEF)
    from win32_raytracer_tpu.persistent import make_dims, step_cfg
    dims = make_dims(cfg, w, h, spp, kpp)
    kw = dict(cfg=step_cfg(cfg), hit_fn=hit_fn)
    st0 = p_respawn_step(cam, st0, salt, jnp.int32(0), dims,
                         cfg=step_cfg(cfg))
    max_steps = (quota + 1) * (cfg.max_depth + 2)
    target = n // 2

    until_st, until_step, until_cnt = p_render_until(
        scene, cam, st0, salt, jnp.int32(0), jnp.int32(target),
        dims, jnp.int32(max_steps), **kw)

    seq = st0
    for step in range(1, max_steps + 1):
        seq = p_bounce_step(scene, cam, seq, salt, jnp.int32(step), dims,
                            **kw)
        if int(jnp.sum(seq.path_alive)) <= target:
            break

    assert int(until_step) == step
    assert int(until_cnt) == int(jnp.sum(seq.path_alive))
    assert int(until_cnt) <= target
    for name, a, b in zip(PathState._fields, until_st, seq):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_staged_render_matches_host_loop_statistically():
    """Full renders, one_shot staged vs off: stage exits re-key lane
    draws at compaction events like any scheduler cadence change, so
    parity is statistical."""
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=11,
                       backend="jnp")
    stg = np.asarray(render_image_persistent(
        scene, None, cfg.replace(one_shot="staged")))
    off = np.asarray(render_image_persistent(
        scene, None, cfg.replace(one_shot="off")))
    assert stg.shape == off.shape == (32, 64, 3)
    d = np.abs(np.sqrt(np.clip(stg, 0, 1)) - np.sqrt(np.clip(off, 0, 1)))
    assert d.mean() < 0.03, d.mean()


def test_multi_k_is_bitwise_invariant():
    """cfg.multi_k only regroups tail bounces into fewer dispatched
    programs (p_bounce_multi_step's k); draws key on (salt, step, lane)
    so the rendered image is identical bit for bit."""
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=11,
                       backend="jnp", one_shot="off")
    base = np.asarray(render_image_persistent(scene, None, cfg))
    k8 = np.asarray(render_image_persistent(
        scene, None, cfg.replace(multi_k=8)))
    k1 = np.asarray(render_image_persistent(
        scene, None, cfg.replace(multi_k=1)))
    np.testing.assert_array_equal(base, k8)
    np.testing.assert_array_equal(base, k1)


def test_one_shot_render_matches_host_loop_statistically():
    """Full renders, one_shot on vs off: the host loop's split events
    re-key lane draws so parity is statistical, like any scheduler
    cadence change."""
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=11,
                       backend="jnp")
    on = np.asarray(render_image_persistent(
        scene, None, cfg.replace(one_shot="on")))
    off = np.asarray(render_image_persistent(
        scene, None, cfg.replace(one_shot="off")))
    assert on.shape == off.shape == (32, 64, 3)
    d = np.abs(np.sqrt(np.clip(on, 0, 1)) - np.sqrt(np.clip(off, 0, 1)))
    assert d.mean() < 0.03, d.mean()


def test_one_shot_conflicts_raise():
    """Binned renders need the host loop's per-period bin sorts: an
    explicit one_shot='on' raises instead of silently unfusing (the
    fuse_bounce='on' contract).  adaptive_alloc is NOT a conflict (its
    phase 2 takes the tail finisher)."""
    import pytest
    from win32_raytracer_tpu.scene.builders import mesh_scene

    scene = mesh_scene(subdivisions=3)
    cfg = RenderConfig(width=32, height=16, samples=8, seed=2,
                       backend="jnp", accel="grid", one_shot="on")
    with pytest.raises(ValueError, match="one_shot"):
        render_image_persistent(scene, None, cfg)

    adaptive_cfg = RenderConfig(width=32, height=16, samples=16, seed=2,
                                backend="jnp", one_shot="on",
                                adaptive_alloc="on")
    img = np.asarray(render_image_persistent(make_test_scene(), None,
                                             adaptive_cfg))
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()

    # tri_rebin is a conflict even though it DISABLES driver-level
    # binning (_derive_bin_box returns None there): the exclusion must
    # probe the cfg/scene directly, not bin_box (round-2 regression —
    # the dead bin_box check silently ran rebin renders one-shot).
    for mode in ("on", "dda"):
        rebin_cfg = RenderConfig(width=32, height=16, samples=8, seed=2,
                                 backend="jnp", accel="grid",
                                 ray_binning="off", tri_rebin=mode,
                                 one_shot="on")
        with pytest.raises(ValueError, match="one_shot"):
            render_image_persistent(scene, None, rebin_cfg)


def test_one_shot_tail_finisher_above_floor(monkeypatch):
    """Chunks above the compaction floor keep the host loop (compaction
    where it pays) and hand the below-floor tail to the one-shot
    finisher.  CPU-sized renders never cross the real 512k floor, so
    shrink it: with floor=4096 a 64x32 kpp-4 chunk (8192 lanes) starts
    above the floor, compacts, and must still complete every sample
    through the finisher."""
    import win32_raytracer_tpu.persistent as P

    monkeypatch.setattr(P, "_COMPACT_FLOOR", 4096)
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=6,
                       backend="jnp")
    fin = np.asarray(P.render_image_persistent(
        scene, None, cfg.replace(one_shot="on")))
    host = np.asarray(P.render_image_persistent(
        scene, None, cfg.replace(one_shot="off")))
    assert fin.shape == host.shape == (32, 64, 3)
    # Same estimator, different step cadence: statistical agreement.
    d = np.abs(np.sqrt(np.clip(fin, 0, 1)) - np.sqrt(np.clip(host, 0, 1)))
    assert d.mean() < 0.03, d.mean()
    # And against the wavefront oracle: no sample lost to the handoff.
    ref = np.asarray(render_image(scene, None, cfg))
    d2 = np.abs(np.sqrt(np.clip(fin, 0, 1)) - np.sqrt(np.clip(ref, 0, 1)))
    assert d2.mean() < 0.03, d2.mean()


def test_staged_tail_above_floor(monkeypatch):
    """Above-floor chunks keep the host loop and hand the below-floor
    tail to the STAGED device loops (run_loop's staged_fn hook) —
    shrink the floor so a CPU-sized chunk crosses it, and check every
    sample still lands (vs host loop and vs the wavefront oracle)."""
    import win32_raytracer_tpu.persistent as P

    monkeypatch.setattr(P, "_COMPACT_FLOOR", 4096)
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=6,
                       backend="jnp")
    stg = np.asarray(P.render_image_persistent(
        scene, None, cfg.replace(one_shot="staged")))
    host = np.asarray(P.render_image_persistent(
        scene, None, cfg.replace(one_shot="off")))
    assert stg.shape == host.shape == (32, 64, 3)
    d = np.abs(np.sqrt(np.clip(stg, 0, 1)) - np.sqrt(np.clip(host, 0, 1)))
    assert d.mean() < 0.03, d.mean()
    ref = np.asarray(render_image(scene, None, cfg))
    d2 = np.abs(np.sqrt(np.clip(stg, 0, 1)) - np.sqrt(np.clip(ref, 0, 1)))
    assert d2.mean() < 0.03, d2.mean()


def test_compact_tail_sorted_flush_exact_across_compactions():
    """Two successive tail_sorted compactions: the composite (dead,
    pixel) key must keep every flush's segment indices ascending and
    the per-pixel radiance accounting exact.  Regression: a dead-bit-
    only key interleaved newly-dead and retained-dead pixels from the
    second compaction on while still promising sorted indices to
    segment_sum — undefined behaviour in XLA."""
    from win32_raytracer_tpu.persistent import PathState, _compact_core

    rng = np.random.default_rng(0)
    n = 64
    pix = np.arange(n, dtype=np.int32)  # unique pixel per lane
    alive = rng.random(n) < 0.6
    rad = rng.random((3, n)).astype(np.float32)
    st = PathState(
        origin=jnp.zeros((3, n), jnp.float32),
        direction=jnp.zeros((3, n), jnp.float32),
        time=jnp.zeros((1, n), jnp.float32),
        throughput=jnp.ones((3, n), jnp.float32),
        radiance_sum=jnp.asarray(rad),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.zeros((1, n), jnp.int32),
        pixel=jnp.asarray(pix)[None],
        path_alive=jnp.asarray(alive)[None],
        s_base=jnp.zeros((1, n), jnp.int32),
        s_quota=jnp.ones((1, n), jnp.int32),
    )
    accum = jnp.zeros((3, n), jnp.float32)

    k1 = int(alive.sum()) + 8  # retain 8 dead lanes in the head
    st, accum = _compact_core(st, accum, k_new=k1, tail_sorted=True)
    p1 = np.asarray(st.pixel[0])
    a1 = np.asarray(st.path_alive[0])
    assert (np.diff(p1[a1]) > 0).all(), "alive block must stay ascending"
    assert (np.diff(p1[~a1]) > 0).all(), "retained dead must be ascending"

    # Kill alternating survivors so newly-dead pixels interleave with
    # the retained-dead block's — the case the old key got wrong.
    a2 = a1.copy()
    a2[np.flatnonzero(a2)[::2]] = False
    st = st._replace(path_alive=jnp.asarray(a2)[None])
    k2 = int(a2.sum()) + 4
    st, accum = _compact_core(st, accum, k_new=k2, tail_sorted=True)

    # Driver-style final flush of whatever is still in the batch.
    accum = accum.at[:, np.asarray(st.pixel[0])].add(st.radiance_sum)
    np.testing.assert_allclose(np.asarray(accum), rad, rtol=0, atol=0)


def test_compact_quantum_grid_and_statistical_match(monkeypatch):
    """cfg.compact_quantum coarsens the above-floor compaction size grid
    (fewer distinct batch shapes = smaller first-time compile
    surface).  _grid_size honors it above the floor only, and a
    render with a coarser quantum stays statistically equivalent (the
    quantum changes compaction sizes, which re-key lane draws like any
    other compaction-cadence knob)."""
    import win32_raytracer_tpu.persistent as P

    q = 1 << 18
    above = P._COMPACT_FLOOR + 1
    assert P._grid_size(above, 1024, q) % q == 0
    # Auto (quantum=0) = the seed-independent mantissa grid.
    assert P._grid_size(above, 1024, 0) == P._mantissa_grid(above)
    # Below the floor the quantum is inert (pow2 sizing).
    assert P._grid_size(1000, 256, q) == P._grid_size(1000, 256, 0)

    # Mantissa grid properties: covers n, lands on the fixed 16-per-
    # octave size set, wastes < 1/16, and is monotone — so the rung-size
    # set visited by ANY render is a subset of a fixed enumerable set
    # (the compile-surface guarantee).
    import random

    rnd = random.Random(0)
    grid_pts = sorted({P._mantissa_grid(n)
                       for n in range(1, 1 << 12)})
    for _ in range(200):
        n = rnd.randrange(1, 1 << 26)
        g = P._mantissa_grid(n)
        assert g >= n and g < n + max(n // 16, 1) + 1
        scale = 1 << max((n - 1).bit_length() - 5, 0)
        assert g % scale == 0
    # Per-octave count: octave [2^20, 2^21) contains exactly 16 sizes.
    pts = {P._mantissa_grid(n) for n in range((1 << 20) + 1, (1 << 21) + 1)}
    assert len(pts) == 16, sorted(pts)
    assert grid_pts == sorted(grid_pts)

    # The render half must actually exercise the ABOVE-floor quantized
    # path: a 64x32@16 kpp-4 chunk is 8192 lanes, far below the real
    # 512k floor (where the quantum is inert and both renders would be
    # identical — vacuous).  Shrink the floor so both arms compact on
    # their (different) ladders: auto (mantissa, ~cur/16 granularity)
    # vs an explicit coarse absolute quantum.
    monkeypatch.setattr(P, "_COMPACT_FLOOR", 2048)
    scene = make_test_scene()
    # Divergence via the chunk-START grid (timing-free): 33x32 @ kpp 4 is
    # 4224 real lanes, above the shrunken floor and on NEITHER grid, so
    # the mantissa arm pads the chunk to 4352 and the 4096-quantum arm to
    # 8192 — different widths from step 0, hence different draws.  (The
    # mid-render ladder itself is timing-dependent at toy scale: uniform
    # quotas make the alive count cliff past the compaction window
    # between checks, which made earlier formulations vacuous.)
    cfg = RenderConfig(width=33, height=32, samples=16, seed=11,
                       backend="jnp", one_shot="off")
    assert P._grid_size(33 * 32 * 4, 1 << 12, 0) != \
        P._grid_size(33 * 32 * 4, 1 << 12, 4096)
    base = np.asarray(P.render_image_persistent(scene, None, cfg))
    coarse = np.asarray(P.render_image_persistent(
        scene, None, cfg.replace(compact_quantum=4096)))
    assert base.shape == coarse.shape
    # The coarser ladder must change compaction sizes (else this test is
    # vacuous again): different sizes re-key lane draws -> different
    # (statistically equivalent) images.
    assert not np.array_equal(base, coarse)
    d = np.abs(np.sqrt(np.clip(base, 0, 1)) - np.sqrt(np.clip(coarse, 0, 1)))
    assert d.mean() < 0.03, d.mean()


def test_compact_quantum_negative_rejected():
    """A negative quantum would make _grid_size round DOWN (floor
    division), passing the shrink gate with k_new < n_alive and silently
    dropping live lanes — both drivers must reject it at entry."""
    scene = make_test_scene()
    cfg = RenderConfig(width=16, height=8, samples=8, backend="jnp",
                       compact_quantum=-1)
    with pytest.raises(ValueError, match="compact_quantum"):
        render_image_persistent(scene, None, cfg)


def test_exact_divmod_any_exactness():
    """_exact_divmod_any must floor-divmod exactly over its full
    contract — x < 2^29, any d >= 1 (it replaced XLA's i32 ``//`` by
    traced scalars in every step core; one wrong quotient misroutes a
    lane's pixel forever)."""
    import win32_raytracer_tpu.persistent as P

    rnd = np.random.RandomState(7)
    xs = np.concatenate([
        rnd.randint(0, 1 << 29, size=2000),
        np.array([0, 1, 2, (1 << 24) - 1, 1 << 24, (1 << 29) - 1]),
    ]).astype(np.int64)
    ds = np.concatenate([
        np.arange(1, 40),
        np.array([127, 128, 129, 130, 131, 1200, 3840, 4800,
                  (1 << 20) + 7, (1 << 24) - 1,
                  # Large divisors: f32(r1) is no longer exactly
                  # representable once |r1| ~ d > 2^24 — the docstring's
                  # "any d >= 1" claim rests on these rows.
                  1 << 24, (1 << 24) + 1, (1 << 26) + 3, (1 << 28) - 1,
                  1 << 28, (1 << 29) - 1]),
        rnd.randint(1, 1 << 24, size=20).astype(np.int64),
        rnd.randint(1 << 24, 1 << 29, size=12).astype(np.int64),
    ])
    for d in ds:
        k = xs // d
        cand = np.unique(np.clip(np.concatenate(
            [xs, k * d, k * d - 1, k * d + 1]), 0, (1 << 29) - 1))
        q, r = P._exact_divmod_any(jnp.asarray(cand, jnp.int32),
                                   jnp.int32(d))
        np.testing.assert_array_equal(np.asarray(q), cand // d,
                                      err_msg=f"q d={d}")
        np.testing.assert_array_equal(np.asarray(r), cand % d,
                                      err_msg=f"r d={d}")
    # Small negatives must keep Python floor semantics: the stratify
    # input gs = s_base + sample is -1 on not-yet-respawned lanes.
    neg = np.array([-1, -2], np.int64)
    for d in (1, 3, 7, 1200):
        q, r = P._exact_divmod_any(jnp.asarray(neg, jnp.int32),
                                   jnp.int32(d))
        np.testing.assert_array_equal(np.asarray(q), neg // d)
        np.testing.assert_array_equal(np.asarray(r), neg % d)


def test_xla_bounce_lean_bit_exact():
    """The XLA step cores' static ``lean`` flag (strat/RR compiled out)
    must be bit-identical to the traced identity forms when the config
    cannot stratify or Russian-roulette."""
    from win32_raytracer_tpu.kernels.dispatch import get_hit_fn_rows_accel
    from win32_raytracer_tpu.persistent import (
        PathState, _resolve_kpp, make_dims, p_bounce_step, p_respawn_step,
        step_cfg)
    from win32_raytracer_tpu.scene.camera import default_camera

    scene = make_test_scene()
    w, h, spp = 32, 16, 8
    cfg = RenderConfig(width=w, height=h, samples=spp, seed=4,
                       backend="jnp")
    assert not cfg.stratify and not cfg.russian_roulette
    scene, hit_fn = get_hit_fn_rows_accel(cfg, scene, None)
    cam = default_camera(w, h)
    kpp = _resolve_kpp(cfg, spp)
    quota = spp // kpp
    n = w * h * kpp
    st0 = PathState(
        origin=jnp.zeros((3, n), jnp.float32),
        direction=jnp.zeros((3, n), jnp.float32).at[2, :].set(1.0),
        time=jnp.zeros((1, n), jnp.float32),
        throughput=jnp.ones((3, n), jnp.float32),
        radiance_sum=jnp.zeros((3, n), jnp.float32),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.full((1, n), -1, jnp.int32),
        pixel=jnp.arange(n, dtype=jnp.int32)[None],
        path_alive=jnp.zeros((1, n), bool),
        s_base=(jnp.arange(n, dtype=jnp.int32) % kpp * quota)[None],
        s_quota=jnp.full((1, n), quota, jnp.int32),
    )
    salt = np.uint32(0xFEED)
    dims = make_dims(cfg, w, h, spp, kpp)
    st0 = p_respawn_step(cam, st0, salt, jnp.int32(0), dims,
                         cfg=step_cfg(cfg))
    full = lean = st0
    for step in range(1, 5):
        full = p_bounce_step(scene, cam, full, salt, jnp.int32(step),
                             dims, cfg=step_cfg(cfg), hit_fn=hit_fn,
                             lean=False)
        lean = p_bounce_step(scene, cam, lean, salt, jnp.int32(step),
                             dims, cfg=step_cfg(cfg), hit_fn=hit_fn,
                             lean=True)
    for name, a, b in zip(PathState._fields, full, lean):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_compact_shrink_knob(monkeypatch):
    """compact_shrink: validation at the driver entry, and a lower
    trigger must SKIP marginal above-floor compactions (fewer, bigger
    events) while staying statistically equivalent.  The floor is
    shrunk (as the quantum test does) so a toy render compacts above
    it at all — at the real 512k floor this shape never would and the
    test would be vacuous."""
    import win32_raytracer_tpu.persistent as P

    scene = make_test_scene()
    bad = RenderConfig(width=16, height=8, samples=8, backend="jnp",
                       compact_shrink=1.5)
    with pytest.raises(ValueError, match="compact_shrink"):
        render_image_persistent(scene, None, bad)

    monkeypatch.setattr(P, "_COMPACT_FLOOR", 512)
    events = []
    orig_compact = P._compact

    def counting(st, accum, **kw):
        events.append((st.pixel.shape[1], kw["k_new"]))
        return orig_compact(st, accum, **kw)

    monkeypatch.setattr(P, "_compact", counting)
    # 64x32@16 kpp-4 = 8192 lanes; the driver's min_lanes floor is 4096,
    # so the one above-floor decision is 8192 -> 4096: a 0.50 drop the
    # 0.90 trigger takes and a 0.35 trigger must skip.
    cfg = RenderConfig(width=64, height=32, samples=16, seed=11,
                       backend="jnp", one_shot="off")
    base = np.asarray(render_image_persistent(scene, None, cfg))
    ev_base = [e for e in events if e[0] > 512]
    events.clear()
    low = np.asarray(render_image_persistent(
        scene, None, cfg.replace(compact_shrink=0.35)))
    ev_low = [e for e in events if e[0] > 512]
    # The 0.90 trigger compacts above the shrunken floor; 0.35 must
    # fire strictly less often there (skipping the marginal events).
    assert ev_base, "no above-floor compaction -> vacuous test shape"
    assert len(ev_low) < len(ev_base), (ev_base, ev_low)
    for cur, k_new in ev_low:
        assert k_new <= int(cur * 0.35)
    assert base.shape == low.shape
    d = np.abs(np.sqrt(np.clip(base, 0, 1)) - np.sqrt(np.clip(low, 0, 1)))
    assert d.mean() < 0.03, d.mean()


def test_compact_route_unit_equivalence():
    """The router compactor (_compact_route_core) must place every
    SURVIVING lane in the identical slot the sort compactor uses (the
    bit-identical-continuation contract on its docstring), synthesize
    inert retained-dead padding (zero quota -> the respawn predicate
    sample < s_quota - 1 can never fire), and conserve radiance: flushed
    accum + retained radiance totals per pixel match the sort engine's."""
    import win32_raytracer_tpu.persistent as P

    rng = np.random.RandomState(3)
    n, k_new, kpp, n_pix = 4096, 2048, 2, 4096
    for trial, frac in enumerate((0.3, 0.45, 0.05)):
        alive = rng.rand(n) < frac
        if alive[:k_new].sum() == 0:
            alive[0] = True
        pix = np.sort(rng.randint(0, n_pix * kpp, n)).astype(np.int32)
        st = P.PathState(
            origin=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            direction=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            time=jnp.asarray(rng.rand(1, n).astype(np.float32)),
            throughput=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            radiance_sum=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            depth=jnp.asarray(rng.randint(0, 9, (1, n)).astype(np.int32)),
            sample=jnp.asarray(rng.randint(0, 4, (1, n)).astype(np.int32)),
            pixel=jnp.asarray(pix[None]),
            path_alive=jnp.asarray(alive[None]),
            s_base=jnp.asarray(rng.randint(0, 8, (1, n)).astype(np.int32)),
            s_quota=jnp.asarray(rng.randint(1, 5, (1, n)).astype(np.int32)),
        )
        accum = jnp.zeros((3, n_pix), jnp.float32)
        for tail_sorted in (False, True):
            new_s, acc_s = P._compact_core(
                st, accum, k_new=k_new, lanes_per_pixel=kpp,
                tail_sorted=tail_sorted)
            new_r, acc_r = P._compact_route_core(
                st, accum, k_new=k_new, lanes_per_pixel=kpp)
            na = int(alive.sum())
            # surviving lanes: identical slots, bit-identical rows
            for f in P.PathState._fields:
                a = np.asarray(getattr(new_s, f))[:, :na]
                b = np.asarray(getattr(new_r, f))[:, :na]
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{f} trial {trial} ts={tail_sorted}")
            # retained-dead padding is inert
            alive_r = np.asarray(new_r.path_alive[0])
            assert not alive_r[na:].any()
            assert (np.asarray(new_r.s_quota[0, na:]) == 0).all()
            assert (np.asarray(new_r.sample[0, na:]) == 0).all()
            assert np.isfinite(np.asarray(new_r.origin[:, na:])).all()
            # radiance conservation per pixel: accum + retained
            def totals(new, acc):
                t = np.asarray(acc).astype(np.float64).copy()
                keep_pix = np.asarray(new.pixel[0]) // kpp
                rad = np.asarray(new.radiance_sum).astype(np.float64)
                np.add.at(t.T, keep_pix, rad.T)
                return t
            np.testing.assert_allclose(
                totals(new_r, acc_r), totals(new_s, acc_s),
                rtol=1e-5, atol=1e-6,
                err_msg=f"conservation trial {trial} ts={tail_sorted}")


def test_compact_route_render_equivalence(monkeypatch):
    """End-to-end: compactor='route' must reproduce the default sort
    engine's render (alive lanes land in identical slots, so draws are
    identical; only flush summation order differs -> FP-tolerance)."""
    import win32_raytracer_tpu.persistent as P

    monkeypatch.setattr(P, "_COMPACT_FLOOR", 512)
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=11,
                       backend="jnp", one_shot="off")
    base = np.asarray(render_image_persistent(scene, None, cfg))
    routed = np.asarray(render_image_persistent(
        scene, None, cfg.replace(compactor="route")))
    assert np.isfinite(routed).all()
    np.testing.assert_allclose(routed, base, rtol=2e-5, atol=2e-6)


def test_compact_route_edges():
    """Router edges: k_new == n (nothing dropped) and a nearly-all-dead
    batch (n_alive tiny) both conserve radiance exactly."""
    import win32_raytracer_tpu.persistent as P

    rng = np.random.RandomState(9)
    n, kpp, n_pix = 1024, 1, 1024
    for k_new, frac in ((n, 0.5), (512, 0.01)):
        alive = rng.rand(n) < frac
        alive[0] = True
        st = P.PathState(
            origin=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            direction=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            time=jnp.asarray(rng.rand(1, n).astype(np.float32)),
            throughput=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            radiance_sum=jnp.asarray(rng.rand(3, n).astype(np.float32)),
            depth=jnp.zeros((1, n), jnp.int32),
            sample=jnp.zeros((1, n), jnp.int32),
            pixel=jnp.arange(n, dtype=jnp.int32)[None],
            path_alive=jnp.asarray(alive[None]),
            s_base=jnp.zeros((1, n), jnp.int32),
            s_quota=jnp.ones((1, n), jnp.int32),
        )
        accum = jnp.zeros((3, n_pix), jnp.float32)
        new, acc = P._compact_route_core(st, accum, k_new=k_new,
                                         lanes_per_pixel=kpp)
        total0 = np.asarray(st.radiance_sum).astype(np.float64).sum()
        total1 = (np.asarray(acc).astype(np.float64).sum()
                  + np.asarray(new.radiance_sum).astype(np.float64).sum())
        np.testing.assert_allclose(total1, total0, rtol=1e-6)
        na = int(alive.sum())
        assert np.asarray(new.path_alive[0]).sum() == min(na, k_new)


def test_window_flush_matches_segment_sum():
    """_window_flush must produce the same per-pixel sums as
    segment_sum (FP association-order tolerance) across dense,
    duplicate-heavy, sparse (residual-path), and edge streams."""
    import win32_raytracer_tpu.persistent as P
    import jax

    rng = np.random.RandomState(21)
    p_pix = 4096
    cases = [
        np.sort(rng.randint(0, p_pix, 5000)),          # dense+dups
        np.sort(rng.randint(0, p_pix, 700)),           # < one block
        np.repeat(np.arange(50), 40),                  # heavy dup runs
        np.sort(rng.choice(p_pix, 300, replace=False)) * 1,  # sparse-ish
        np.sort(np.concatenate([                       # sparse: residual
            rng.randint(0, 64, 800),
            rng.randint(p_pix - 64, p_pix, 800)])),
        np.array([0]),                                 # single entry
        np.array([p_pix - 1] * 7),                     # last pixel only
    ]
    for t, pix in enumerate(cases):
        pix = pix.astype(np.int32)
        rad = rng.rand(3, pix.size).astype(np.float32)
        accum0 = rng.rand(3, p_pix).astype(np.float32)
        want = accum0 + np.asarray(jax.ops.segment_sum(
            jnp.asarray(rad).T, jnp.asarray(pix),
            num_segments=p_pix)).T
        got = np.asarray(P._window_flush(
            jnp.asarray(accum0), jnp.asarray(pix), jnp.asarray(rad)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6,
                                   err_msg=f"case {t}")


def test_compact_flush_window_matches_scatter():
    """_compact_core(flush='window') == flush='scatter' (same kept
    state bit-exactly; accum to FP tolerance), both tail modes."""
    import win32_raytracer_tpu.persistent as P

    rng = np.random.RandomState(4)
    n, k_new, kpp, n_pix = 4096, 2048, 2, 2048
    alive = rng.rand(n) < 0.4
    pix = np.sort(rng.randint(0, n_pix * kpp, n)).astype(np.int32)
    st = P.PathState(
        origin=jnp.asarray(rng.rand(3, n).astype(np.float32)),
        direction=jnp.asarray(rng.rand(3, n).astype(np.float32)),
        time=jnp.asarray(rng.rand(1, n).astype(np.float32)),
        throughput=jnp.asarray(rng.rand(3, n).astype(np.float32)),
        radiance_sum=jnp.asarray(rng.rand(3, n).astype(np.float32)),
        depth=jnp.zeros((1, n), jnp.int32),
        sample=jnp.zeros((1, n), jnp.int32),
        pixel=jnp.asarray(pix[None]),
        path_alive=jnp.asarray(alive[None]),
        s_base=jnp.zeros((1, n), jnp.int32),
        s_quota=jnp.ones((1, n), jnp.int32),
    )
    accum = jnp.zeros((3, n_pix), jnp.float32)
    for ts in (False, True):
        ns_, acc_s = P._compact_core(st, accum, k_new=k_new,
                                     lanes_per_pixel=kpp, tail_sorted=ts)
        nw_, acc_w = P._compact_core(st, accum, k_new=k_new,
                                     lanes_per_pixel=kpp, tail_sorted=ts,
                                     flush="window")
        for f in P.PathState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ns_, f)), np.asarray(getattr(nw_, f)),
                err_msg=f"{f} ts={ts}")
        np.testing.assert_allclose(np.asarray(acc_w), np.asarray(acc_s),
                                   rtol=2e-6, atol=2e-6)


def test_render_flush_window_equivalence(monkeypatch):
    """End-to-end: flush_mode='window' must reproduce the scatter-flush
    render (kept lanes identical -> identical draws; flush order FP)."""
    import win32_raytracer_tpu.persistent as P

    monkeypatch.setattr(P, "_COMPACT_FLOOR", 512)
    scene = make_test_scene()
    cfg = RenderConfig(width=64, height=32, samples=16, seed=11,
                       backend="jnp", one_shot="off")
    base = np.asarray(render_image_persistent(scene, None, cfg))
    win = np.asarray(render_image_persistent(
        scene, None, cfg.replace(flush_mode="window")))
    assert np.isfinite(win).all()
    np.testing.assert_allclose(win, base, rtol=2e-5, atol=2e-6)
