"""Animated flythrough (BASELINE config 5) over the virtual mesh."""

import numpy as np

from win32_raytracer_tpu.animation import orbit_path, render_animation
from win32_raytracer_tpu.config import RenderConfig
from win32_raytracer_tpu.parallel.shard import make_mesh
from win32_raytracer_tpu.scene.builders import test_scene as make_test_scene


def test_orbit_path_geometry():
    cams = orbit_path(look_to=(0, 1, 0), radius=10.0, height=3.0, n_frames=8)
    assert len(cams) == 8
    for cam in cams:
        o = np.asarray(cam.origin)
        assert abs(np.hypot(o[0], o[2]) - 10.0) < 1e-4
        assert abs(o[1] - 3.0) < 1e-6
    # distinct positions
    pts = np.stack([np.asarray(c.origin) for c in cams])
    assert np.ptp(pts[:, 0]) > 15


def test_flythrough_frame_batched(tmp_path):
    """Multi-frame persistent batching: F frames rendered as ONE virtual
    tall image must statistically match per-frame renders of the same
    cameras, be deterministic, and hit the disk/callback plumbing."""
    scene = make_test_scene()
    cfg = RenderConfig(width=24, height=16, samples=32, seed=4,
                       backend="jnp", scheduler="persistent")
    cams = orbit_path(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                      n_frames=3, aspect_ratio=1.5)
    got = []
    frames = render_animation(
        scene, cams, cfg, out_pattern=str(tmp_path / "b_%04d.png"),
        batch_frames=3,
        frame_callback=lambda i, img, ms: got.append(i))
    assert len(frames) == 3 and got == [0, 1, 2]
    assert all(f.shape == (16, 24, 3) for f in frames)
    assert (tmp_path / "b_0002.png").exists()
    # determinism: identical rerun
    frames2 = render_animation(scene, cams, cfg, batch_frames=3)
    for a, b in zip(frames, frames2):
        np.testing.assert_array_equal(a, b)
    # each batched frame matches an unbatched render of the same camera
    # statistically (different RNG streams, same estimator)
    singles = render_animation(scene, cams, cfg, batch_frames=1)
    for a, b in zip(frames, singles):
        d = np.abs(a.astype(float) - b.astype(float)).mean()
        assert d < 6.0, f"batched-vs-single mean diff {d}"
    # camera motion is visible inside the batch
    assert np.abs(frames[0].astype(int) - frames[2].astype(int)).mean() > 1.0


def test_flythrough_sharded_over_mesh(eight_devices, tmp_path):
    scene = make_test_scene()
    cfg = RenderConfig(width=32, height=16, samples=8, seed=2, backend="jnp")
    cams = orbit_path(look_to=(0, 0, 0), radius=14.0, height=2.0, n_frames=3,
                      aspect_ratio=2.0)
    got = []
    frames = render_animation(
        scene, cams, cfg,
        out_pattern=str(tmp_path / "fly_%04d.png"),
        mesh=make_mesh(8), shard_mode="spp",
        frame_callback=lambda i, img, ms: got.append((i, img.shape, ms > 0)),
    )
    assert len(frames) == 3
    assert all(f.shape == (16, 32, 3) for f in frames)
    assert (tmp_path / "fly_0002.png").exists()
    assert got == [(0, (16, 32, 3), True), (1, (16, 32, 3), True),
                   (2, (16, 32, 3), True)]
    # camera actually moves: frames differ
    assert np.abs(frames[0].astype(int) - frames[1].astype(int)).mean() > 1.0


def test_auto_batch_frames_and_multiframe_kpp():
    """Auto batching packs as many frames per batch as the lane budget
    allows at the multi-frame kpp rule (quota over replicas).  Long
    animations split evenly."""
    from win32_raytracer_tpu.animation import _auto_batch_frames
    from win32_raytracer_tpu.persistent import _resolve_kpp

    cfg5 = RenderConfig(width=640, height=480, samples=32)
    # 640*480*8 = 2.46M lanes at kpp1 >= the 2M target: one batch.
    assert _auto_batch_frames(cfg5, 8) == 8
    assert _resolve_kpp(cfg5, 32, 8, 640 * 480) == 1
    # kpp must still divide spp: 8 frames of 160x120 at spp 6 -> kpp 2
    # is the smallest divisor reaching... (too few pixels: falls back).
    assert _resolve_kpp(cfg5, 32, 1, 640 * 480) == 8  # single-frame rule
    # Tiny frames: even kpp8 x 8f = 1.2M < target -> single-frame rule
    # (kpp4 at spp16: quota >= 4), and the budget fits all frames in
    # one batch.
    tiny = RenderConfig(width=160, height=120, samples=16)
    assert _resolve_kpp(tiny, 16, 8, 160 * 120) == 4
    assert _auto_batch_frames(tiny, 8) == 8
    assert _auto_batch_frames(tiny, 3) == 3
    # Long animation at a big frame: budget caps the batch, even split.
    big = RenderConfig(width=1920, height=1080, samples=8)
    bf = _auto_batch_frames(big, 64)
    n_batches = -(-64 // bf)
    assert 1 <= bf <= 64 and n_batches * bf - 64 < bf
    # Single frame or unknown F: plain budget clamp.
    assert _auto_batch_frames(cfg5, 1) == 1
    assert _auto_batch_frames(cfg5) >= 1


def test_flythrough_mesh_batched(eight_devices, tmp_path):
    """Default shard_mode='rows' on a mesh now frame-batches through the
    sharded persistent driver; frames match the per-frame mesh renders
    statistically and hit the disk/callback plumbing."""
    scene = make_test_scene()
    cfg = RenderConfig(width=24, height=16, samples=16, seed=7,
                       backend="jnp", scheduler="persistent")
    cams = orbit_path(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                      n_frames=3, aspect_ratio=1.5)
    mesh = make_mesh(4)
    got = []
    frames = render_animation(
        scene, cams, cfg, out_pattern=str(tmp_path / "mb_%04d.png"),
        mesh=mesh, batch_frames=3,
        frame_callback=lambda i, img, ms: got.append(i))
    assert len(frames) == 3 and got == [0, 1, 2]
    assert all(f.shape == (16, 24, 3) for f in frames)
    assert (tmp_path / "mb_0002.png").exists()
    # spp-sharded mesh animations cannot batch: explicit request raises
    import pytest
    with pytest.raises(ValueError):
        render_animation(scene, cams, cfg, mesh=mesh, shard_mode="spp",
                         batch_frames=2)
    # statistical match against per-frame renders on the same mesh
    singles = render_animation(scene, cams, cfg, mesh=mesh,
                               batch_frames=1)
    for a, b in zip(frames, singles):
        d = np.abs(a.astype(float) - b.astype(float)).mean()
        assert d < 6.0, f"mesh-batched-vs-single mean diff {d}"


def test_flythrough_odd_framecount_auto_batch():
    """3 frames auto-split into 2+1 batches: the singleton tail batch
    (a LIST of one camera) must render like the plain single-camera
    image on both drivers (regression: the stacked [1]-leading camera
    used to reach the respawn core un-selected)."""
    from win32_raytracer_tpu.parallel.persistent_shard import (
        render_image_persistent_sharded)
    from win32_raytracer_tpu.persistent import render_image_persistent
    from win32_raytracer_tpu.parallel.shard import make_mesh

    scene = make_test_scene()
    cfg = RenderConfig(width=24, height=16, samples=16, seed=5,
                       backend="jnp", scheduler="persistent")
    cams = orbit_path(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                      n_frames=3, aspect_ratio=1.5)
    # singleton list == plain camera, bitwise (both drivers)
    lin_l = np.asarray(render_image_persistent(scene, cams[:1], cfg))
    lin_c = np.asarray(render_image_persistent(scene, cams[0], cfg))
    assert lin_l.shape == (1, 16, 24, 3)
    np.testing.assert_array_equal(lin_l[0], lin_c)
    mesh = make_mesh(4)
    lin_ls = np.asarray(render_image_persistent_sharded(
        scene, cams[:1], cfg, mesh))
    lin_cs = np.asarray(render_image_persistent_sharded(
        scene, cams[0], cfg, mesh))
    assert lin_ls.shape == (1, 16, 24, 3)
    np.testing.assert_array_equal(lin_ls[0], lin_cs)
    # end-to-end: auto batching (2+1) produces 3 well-formed frames on
    # the single-chip driver AND the mesh
    frames = render_animation(scene, cams, cfg)
    assert len(frames) == 3
    frames_m = render_animation(scene, cams, cfg, mesh=mesh)
    assert len(frames_m) == 3
    for a, b in zip(frames, frames_m):
        assert a.shape == b.shape == (16, 24, 3)
        assert np.abs(a.astype(float) - b.astype(float)).mean() < 6.0


def test_flythrough_resume_skips_existing(tmp_path, monkeypatch):
    """resume=True: batches whose frame files exist are read back, not
    re-rendered; missing batches rerender with their original seeds, so
    the resumed animation equals the uninterrupted one bit-exactly."""
    import win32_raytracer_tpu.persistent as P

    scene = make_test_scene()
    cfg = RenderConfig(width=24, height=16, samples=16, seed=11,
                       backend="jnp", scheduler="persistent")
    cams = orbit_path(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                      n_frames=4, aspect_ratio=1.5)
    pattern = str(tmp_path / "r_%04d.png")
    full = render_animation(scene, cams, cfg, out_pattern=pattern,
                            batch_frames=2)
    # Simulate a crash after batch 0: delete batch 1's frames.
    (tmp_path / "r_0002.png").unlink()
    (tmp_path / "r_0003.png").unlink()
    calls = []
    orig = P.render_image_persistent
    monkeypatch.setattr(P, "render_image_persistent",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    resumed = render_animation(scene, cams, cfg, out_pattern=pattern,
                               batch_frames=2, resume=True)
    assert len(calls) == 1                 # only the missing batch ran
    assert len(resumed) == 4
    for a, b in zip(full, resumed):
        np.testing.assert_array_equal(a, b)
    # resume with everything present: zero renders
    calls.clear()
    again = render_animation(scene, cams, cfg, out_pattern=pattern,
                             batch_frames=2, resume=True)
    assert calls == [] and len(again) == 4
    for a, b in zip(full, again):
        np.testing.assert_array_equal(a, b)


def test_flythrough_resume_rerenders_bad_files(tmp_path):
    """resume=True re-renders (not crashes) when a frame file is empty,
    corrupt, or the wrong resolution; explicit batching on a wavefront
    scheduler raises instead of silently overriding it."""
    scene = make_test_scene()
    cfg = RenderConfig(width=24, height=16, samples=16, seed=12,
                       backend="jnp", scheduler="persistent")
    cams = orbit_path(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                      n_frames=2, aspect_ratio=1.5)
    pattern = str(tmp_path / "x_%04d.png")
    full = render_animation(scene, cams, cfg, out_pattern=pattern,
                            batch_frames=2)
    # Corrupt one frame: empty file (simulated torn write from an old
    # non-atomic writer or another tool).
    (tmp_path / "x_0001.png").write_bytes(b"")
    resumed = render_animation(scene, cams, cfg, out_pattern=pattern,
                               batch_frames=2, resume=True)
    for a, b in zip(full, resumed):
        np.testing.assert_array_equal(a, b)
    # Wrong resolution: re-render rather than returning mixed shapes.
    from win32_raytracer_tpu.io.image import write_image
    write_image(str(tmp_path / "x_0000.png"),
                np.zeros((8, 8, 3), np.uint8))
    resumed2 = render_animation(scene, cams, cfg, out_pattern=pattern,
                                batch_frames=2, resume=True)
    assert all(f.shape == (16, 24, 3) for f in resumed2)
    for a, b in zip(full, resumed2):
        np.testing.assert_array_equal(a, b)
    # Explicit batching never silently drops a scheduler request.
    import pytest
    with pytest.raises(ValueError, match="persistent"):
        render_animation(scene, cams, cfg.replace(scheduler="wavefront"),
                         batch_frames=2)
