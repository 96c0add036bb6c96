"""Animated camera flythroughs (BASELINE.json config 5: tile-parallel
animated camera flythrough sharded over the mesh via shard_map and a
cross-device reduction).

The reference has no animation (one hard-coded camera, RayTracer.cpp:
906-915); this drives the same render pipeline over a camera path, with
optional mesh sharding per frame.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .config import RenderConfig
from .scene.camera import Camera, make_camera


def orbit_path(
    look_to=(0.0, 1.0, 0.0),
    radius: float = 16.0,
    height: float = 2.0,
    n_frames: int = 24,
    vfov_degrees: float = 20.0,
    aspect_ratio: float = 4.0 / 3.0,
    aperture: float = 0.1,
    up=(0.0, 1.0, 0.0),
    start_angle: float = 0.0,
    sweep: float = 2.0 * math.pi,
) -> List[Camera]:
    """Circular orbit around ``look_to`` (focus follows the target)."""
    cams = []
    look_to = np.asarray(look_to, np.float32)
    for i in range(n_frames):
        a = start_angle + sweep * i / n_frames
        look_from = np.asarray(
            [look_to[0] + radius * math.cos(a), height,
             look_to[2] + radius * math.sin(a)], np.float32)
        focus = float(np.linalg.norm(look_to - look_from))
        cams.append(make_camera(look_from, look_to, up, vfov_degrees,
                                aspect_ratio, aperture, focus))
    return cams


def _auto_batch_frames(cfg: RenderConfig, n_frames: int = 0) -> int:
    """Frames per persistent batch: frame batching amortizes the
    scheduler tail, the alive-check syncs, and the dispatch floor over
    all frames in a batch.  The lane budget (~10.5M; state is ~76 B/lane
    so ~0.8 GB of device memory) is cheap next to the per-frame fixed costs it
    removes; frames beyond the budget would split into multiple chunks
    and amortize nothing extra.

    As many frames per batch as the budget allows, sized at the
    multi-frame kpp rule (persistent._resolve_kpp: smallest kpp
    reaching the lane target — quota over replicas); longer per-lane
    quotas outweigh overlapping one batch's fetch with the next one's
    compute.  Long animations still split (budget), evenly, and batch
    i+1's compute still overlaps batch i's fetch."""
    from .persistent import _resolve_kpp

    budget = max(cfg.rays_per_chunk, 10 << 20)
    frames_cap = max(1, min(n_frames or 8,
                            budget // max(1, cfg.width * cfg.height)))
    kpp = _resolve_kpp(cfg, cfg.samples, max(frames_cap, 2),
                       cfg.width * cfg.height)
    per_frame = cfg.width * cfg.height * kpp
    bf = max(1, min(frames_cap, budget // max(1, per_frame)))
    if n_frames >= 2:
        # Even split into ceil(F/bf) batches.
        n_batches = -(-n_frames // bf)
        bf = -(-n_frames // n_batches)
    return bf


def render_animation(
    scene,
    cameras: Sequence[Camera],
    cfg: Optional[RenderConfig] = None,
    out_pattern: Optional[str] = None,
    mesh=None,
    shard_mode: str = "rows",
    frame_callback: Optional[Callable[[int, np.ndarray, float], None]] = None,
    batch_frames: int = 0,
    resume: bool = False,
) -> List[np.ndarray]:
    """Render one image per camera; optionally write ``out_pattern % i``
    (e.g. ``"fly_%04d.png"``) and/or invoke ``frame_callback(i, img, ms)``.

    Frame seeds derive from (cfg.seed, batch index) so animations are
    reproducible and frames decorrelated.

    ``resume``: with ``out_pattern``, skip any batch whose frame files
    all exist already AND read back at this render's resolution — an
    interrupted animation rerun with the same arguments continues where
    it stopped, exactly (batch seeds depend only on the batch start
    index).  Unreadable or wrong-shape files re-render the batch
    (writes are atomic, so a mid-write kill leaves no torn file).
    Resumed frames invoke ``frame_callback`` with ``ms=0.0``.

    ``batch_frames`` (0 = auto): on the persistent scheduler, render
    this many frames per BATCH — the whole group runs as one virtual
    tall image (persistent.py multi-frame contract), single-chip or
    row-sharded over ``mesh`` (parallel.persistent_shard), so per-frame
    fixed costs amortize.  1 disables batching (and is the only mode
    for wavefront renders and non-row mesh shard modes).
    """
    cfg = cfg or RenderConfig()
    from .config import resolve_scheduler
    scheduler = resolve_scheduler(cfg)
    cameras = list(cameras)
    # Multi-frame batching rides the persistent scheduler: single-chip,
    # or sharded over a mesh (row-block shard modes only — the virtual
    # tall image is row-sharded by construction).
    mesh_batchable = mesh is None or shard_mode in ("rows", "persistent")
    if batch_frames <= 0:
        batch_frames = (_auto_batch_frames(cfg, len(cameras))
                        if scheduler == "persistent" and mesh_batchable
                        else 1)
    if batch_frames > 1 and mesh is not None and not mesh_batchable:
        raise ValueError(
            f"batch_frames={batch_frames} needs shard_mode 'rows' or "
            f"'persistent' on a mesh (got {shard_mode!r})")
    if batch_frames > 1 and scheduler != "persistent":
        # Never silently override an explicit scheduler/determinism
        # request: batching exists only on the persistent scheduler.
        raise ValueError(
            f"batch_frames={batch_frames} requires the persistent "
            f"scheduler (resolved scheduler is {scheduler!r})")

    def read_back(path):
        """Read a prior run's frame; None (-> re-render) when missing,
        unreadable, or not this render's [H, W, 3] resolution."""
        if not os.path.exists(path):
            return None
        from .io.image import read_image
        try:
            img = read_image(path)
        except Exception:
            return None
        return img if img.shape == (cfg.height, cfg.width, 3) else None

    def emit(i, img, ms):
        if out_pattern:
            from .io.image import write_image
            os.makedirs(os.path.dirname(out_pattern) or ".", exist_ok=True)
            write_image(out_pattern % i, img)
        if frame_callback:
            frame_callback(i, img, ms)

    frames: List[np.ndarray] = []
    if batch_frames > 1:
        from .render import tonemap

        if mesh is not None:
            from .parallel.persistent_shard import (
                render_image_persistent_sharded)

            def render_batch(s, group, c):
                return render_image_persistent_sharded(s, group, c, mesh)
        else:
            from .persistent import render_image_persistent as render_batch

        from .persistent import _resolve_kpp

        # Size with the MULTI-frame kpp rule (the one the batch driver
        # resolves): the single-frame rule can pick a larger kpp (e.g.
        # spp 4-8 on small frames), undersizing rays_per_chunk so the
        # virtual tall image silently splits into row chunks —
        # reintroducing the per-frame tail the batching removes.
        per_frame = cfg.width * cfg.height * _resolve_kpp(
            cfg, cfg.samples, batch_frames, cfg.width * cfg.height)
        pending = None  # (b0, tonemapped device arrays, per-frame ms)

        def materialize(p):
            # Frame-by-frame fetch+emit: all transfers were prefetched, so
            # np.asarray(frame i) waits only for ITS bytes while frames
            # i+1.. keep transferring — the PNG encode of frame i
            # overlaps the remaining transfers (matters for the last
            # batch, whose transfer has no successor compute to hide in).
            # ``ms`` was captured when the batch's compute drained (before
            # the pipeline deferred it behind the next batch) — measuring
            # here would bill the NEXT batch's render to these frames.
            b0_, dev, ms = p
            for i, a in enumerate(dev):
                img = np.asarray(a)              # device->host fetch
                frames.append(img)
                emit(b0_ + i, img, ms)

        def prefetch(dev):
            # Enqueue the device->host pull NOW (right after this batch's
            # compute drains): the transfer runs while the host
            # drives the NEXT batch's scheduler loop (or, for the last
            # batch, while it PNG-encodes the previous one), so the later
            # np.asarray in materialize finds the bytes already landed.
            for a in dev:
                try:
                    a.copy_to_host_async()
                except Exception:
                    break  # backend without async fetch: asarray blocks

        for b0 in range(0, len(cameras), batch_frames):
            group = cameras[b0:b0 + batch_frames]
            if resume and out_pattern:
                imgs = []
                for i in range(len(group)):  # stop at the first gap —
                    img = read_back(out_pattern % (b0 + i))  # the batch
                    if img is None:          # re-renders whole anyway
                        break
                    imgs.append(img)
                if len(imgs) == len(group):
                    # Whole batch already on disk: read it back in frame
                    # order (drain the pipeline first to keep ordering).
                    if pending is not None:
                        materialize(pending)
                        pending = None
                    for i, img in enumerate(imgs):
                        frames.append(img)
                        if frame_callback:
                            frame_callback(b0 + i, img, 0.0)
                    continue
            # One chunk per batch: chunking the virtual tall image would
            # reintroduce the per-chunk tail the batching exists to kill.
            fcfg = cfg.replace(
                seed=cfg.seed * 1000003 + b0,
                rays_per_chunk=max(cfg.rays_per_chunk,
                                   len(group) * per_frame))
            t0 = time.perf_counter()
            linear = render_batch(scene, group, fcfg)
            dev = [tonemap(linear[i]) for i in range(len(group))]
            prefetch(dev)
            # Per-frame wall: the render_batch host loop blocks on its
            # own alive-check syncs, so compute has drained by here (the
            # prefetched d2h transfer is deliberately excluded — it rides
            # under the next batch's compute).
            ms = (time.perf_counter() - t0) * 1e3 / len(group)
            # Materialize the PREVIOUS batch only now: its transfer was
            # prefetched before this batch ran, so the asarray is a wait
            # at worst, and the emit work (PNG encode on the 1-core host)
            # overlaps THIS batch's just-enqueued transfer.
            if pending is not None:
                materialize(pending)
            pending = (b0, dev, ms)
        if pending is not None:
            materialize(pending)
        return frames

    from .api import render as _render

    for i, cam in enumerate(cameras):
        if resume and out_pattern:
            img = read_back(out_pattern % i)
            if img is not None:
                frames.append(img)
                if frame_callback:
                    frame_callback(i, img, 0.0)
                continue
        fcfg = cfg.replace(seed=cfg.seed * 1000003 + i)
        t0 = time.perf_counter()
        res = _render(scene, cam=cam, cfg=fcfg, mesh=mesh,
                      shard_mode=shard_mode)
        ms = (time.perf_counter() - t0) * 1e3
        frames.append(res.image)
        emit(i, res.image, ms)
    return frames
