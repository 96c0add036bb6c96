"""Checkpoint / resume for long high-spp renders.

The reference has none (SURVEY.md §5: a render runs start-to-finish and
only ``out.bmp`` persists, Game.cpp:104), but its tile decomposition was
already resumable-shaped (``RenderResult::imageParts``).  Two granularities
here:

* **Pass level** (both schedulers): a render is split into ``passes`` of
  ``samples/passes`` spp each; after every pass the running radiance sum
  and pass count go to an ``.npz``.  Pass RNG seeds derive from
  (seed, pass index), so a resumed render produces exactly the image an
  uninterrupted (checkpointed) one would.
* **Chunk level** (persistent scheduler): within a pass, the production
  scheduler renders row-chunks (persistent.py driver); after each chunk
  the [3, H*W] device accumulator and the next row index are persisted
  too, so even a single-pass 4K render resumes mid-image.  Per-chunk RNG
  salts depend only on (seed, y0) — resume is bit-exact.

Fetch-cost note: every save pulls the accumulator device->host —
~8 MB per pass at 4K for the f64 pass accumulator, plus ~100 MB per
chunk save at 4K for the f32 chunk accumulator.  Chunk-level saves are
therefore opt-in via ``chunk_checkpoints=True``.
"""

from __future__ import annotations

import os

from typing import Optional

import numpy as np

from ..config import RenderConfig
from ..render import render_image, tonemap
from ..scene.camera import Camera, default_camera
from ..scene.spheres import SphereScene

# 3: + rays_per_chunk / lanes_per_pixel (chunk boundaries and lane
# encoding feed the per-chunk draw salts, so the documented bit-exact
# resume guarantee depends on them matching across invocations).
_FORMAT = 3


class _Budget(Exception):
    """Internal: raised by the chunk callback when the chunk budget for
    this invocation is exhausted (after saving the checkpoint)."""


def load_checkpoint(path: str):
    """Returns (accumulator [H,W,3] f64, passes_done, meta dict) or None.

    ``meta`` additionally carries ``chunk_accum`` ([3, H*W] f32 or None)
    and ``chunk_y0`` for a mid-pass persistent-scheduler checkpoint.
    """
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if int(z["format"]) not in (1, 2, _FORMAT):
            raise ValueError(f"unsupported checkpoint format {z['format']}")
        meta = dict(width=int(z["width"]), height=int(z["height"]),
                    samples=int(z["samples"]), seed=int(z["seed"]),
                    passes=int(z["passes"]),
                    chunk_accum=None, chunk_y0=0)
        if int(z["format"]) >= 2 and z["chunk_accum"].size:
            meta["chunk_accum"] = np.asarray(z["chunk_accum"], np.float32)
            meta["chunk_y0"] = int(z["chunk_y0"])
        if int(z["format"]) >= 3:
            meta["rays_per_chunk"] = int(z["rays_per_chunk"])
            meta["lanes_per_pixel"] = int(z["lanes_per_pixel"])
        return np.asarray(z["accum"], np.float64), int(z["passes_done"]), meta


def _save(path: str, accum: np.ndarray, passes_done: int,
          cfg: RenderConfig, passes: int,
          chunk_accum: Optional[np.ndarray] = None,
          chunk_y0: int = 0) -> None:
    tmp = path + ".tmp.npz"  # ends in .npz so np.savez won't rename it
    np.savez(tmp, format=_FORMAT, accum=accum, passes_done=passes_done,
             width=cfg.width, height=cfg.height, samples=cfg.samples,
             seed=cfg.seed, passes=passes,
             rays_per_chunk=cfg.rays_per_chunk,
             lanes_per_pixel=cfg.lanes_per_pixel,
             chunk_accum=(np.zeros(0, np.float32) if chunk_accum is None
                          else chunk_accum),
             chunk_y0=chunk_y0)
    os.replace(tmp, path)  # atomic publish


def _resolve_scheduler(cfg: RenderConfig, spp_pass: int) -> str:
    """render.render's auto rule, on the PER-PASS spp."""
    from ..config import resolve_scheduler
    return resolve_scheduler(cfg, spp_pass)


def render_with_checkpoints(
    scene: SphereScene,
    cam: Optional[Camera],
    cfg: RenderConfig,
    checkpoint_path: str,
    passes: int = 10,
    hit_fn=None,
    max_passes_per_run: Optional[int] = None,
    chunk_checkpoints: bool = False,
    max_chunks_per_run: Optional[int] = None,
    mesh=None,
) -> Optional[np.ndarray]:
    """Render ``cfg.samples`` spp in ``passes`` resumable passes.

    Honors ``cfg.scheduler`` (auto resolves per pass like render.render),
    so the production persistent scheduler is checkpointable — closing
    the round-1 gap where only the wavefront path could resume.

    Returns the u8 image once all passes are done; the checkpoint holds
    partial sums until then.  ``max_passes_per_run`` bounds how many
    passes this invocation performs; ``chunk_checkpoints`` additionally
    saves after every row-chunk on the persistent path (mid-pass
    resume), and ``max_chunks_per_run`` bounds chunks per invocation
    (implies chunk_checkpoints).  If the render is still incomplete
    afterwards, returns None — call again to resume.

    ``mesh``: checkpoint a MULTI-CHIP render — each pass runs through
    the sharded persistent driver (parallel.persistent_shard) at
    pass-level granularity (the sharded driver renders an image in one
    piece, so there are no chunk cut points).  Pass seeds are identical
    to the single-chip decomposition.
    """
    if cfg.samples % passes:
        raise ValueError(f"samples ({cfg.samples}) must divide into "
                         f"passes ({passes})")
    if max_chunks_per_run is not None:
        chunk_checkpoints = True
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    spp_pass = cfg.samples // passes
    scheduler = _resolve_scheduler(cfg, spp_pass)
    if mesh is not None:
        if scheduler != "persistent":
            raise ValueError(
                "mesh checkpointing runs through the sharded persistent "
                f"driver; got scheduler {scheduler!r} (per-pass spp "
                f"{spp_pass} resolves wavefront under 8 — use more "
                "samples or fewer passes)")
        if chunk_checkpoints:
            raise ValueError(
                "chunk_checkpoints is single-chip only (the sharded "
                "driver has no row-chunk cut points); mesh renders "
                "checkpoint at pass granularity")
    elif chunk_checkpoints and scheduler != "persistent":
        # Same contract as the mesh branch: refuse instead of silently
        # running unbounded (the wavefront path has no chunk callback,
        # so a caller's chunk budget would never decrement).
        raise ValueError(
            "chunk_checkpoints/max_chunks_per_run need the persistent "
            f"scheduler; per-pass spp {spp_pass} resolves "
            f"{scheduler!r} — use more samples, fewer passes, or "
            "scheduler='persistent'")

    if hit_fn is None and scheduler == "wavefront":
        from ..kernels.dispatch import get_hit_fn
        hit_fn = get_hit_fn(cfg)
    elif hit_fn is not None and scheduler == "persistent":
        # The persistent drivers (single-chip and sharded) run lane-major
        # (ops/rows.py): adapt an explicitly-passed column hit_fn the
        # same way render.render does (render.py:292), or it would
        # receive transposed [3, N] args.
        from ..ops.rows import hit_rows_adapter
        hit_fn = hit_rows_adapter(hit_fn)

    state = load_checkpoint(checkpoint_path)
    if state is not None:
        accum, done, meta = state
        if (meta["width"], meta["height"], meta["samples"], meta["seed"],
                meta["passes"]) != (cfg.width, cfg.height, cfg.samples,
                                    cfg.seed, passes):
            raise ValueError("checkpoint does not match this render config")
        if "rays_per_chunk" in meta and (
                (meta["rays_per_chunk"], meta["lanes_per_pixel"])
                != (cfg.rays_per_chunk, cfg.lanes_per_pixel)):
            # Chunk boundaries and lane encoding feed the per-chunk draw
            # salts: resuming with different values still completes a
            # correct render but silently breaks the documented
            # bit-exact-resume guarantee — refuse instead.
            raise ValueError(
                "checkpoint was written with rays_per_chunk="
                f"{meta['rays_per_chunk']}, lanes_per_pixel="
                f"{meta['lanes_per_pixel']}; resuming with "
                f"({cfg.rays_per_chunk}, {cfg.lanes_per_pixel}) would "
                "not be bit-exact")
        chunk_accum, chunk_y0 = meta["chunk_accum"], meta["chunk_y0"]
    else:
        accum = np.zeros((cfg.height, cfg.width, 3), np.float64)
        done = 0
        chunk_accum, chunk_y0 = None, 0

    end = passes if max_passes_per_run is None else min(
        passes, done + max_passes_per_run)
    chunks_left = [max_chunks_per_run] if max_chunks_per_run else [None]

    for p in range(done, end):
        pass_cfg = cfg.replace(samples=spp_pass,
                               seed=cfg.seed * 1000003 + p)
        if mesh is not None:
            from ..parallel.persistent_shard import (
                render_image_persistent_sharded)
            linear = np.asarray(render_image_persistent_sharded(
                scene, cam, pass_cfg, mesh, hit_fn=hit_fn), np.float64)
        elif scheduler == "persistent":
            from ..persistent import render_image_persistent
            resume_kw = {}
            if chunk_accum is not None:
                resume_kw = dict(resume_accum=chunk_accum,
                                 resume_y0=chunk_y0)
                chunk_accum, chunk_y0 = None, 0

            def on_chunk(acc, next_y0, _p=p, _cfg=pass_cfg):
                if next_y0 >= _cfg.height:
                    return  # final chunk: the pass-level save handles it
                if chunk_checkpoints:
                    _save(checkpoint_path, accum, _p, cfg, passes,
                          chunk_accum=np.asarray(acc, np.float32),
                          chunk_y0=next_y0)
                if chunks_left[0] is not None:
                    chunks_left[0] -= 1
                    if chunks_left[0] <= 0:
                        raise _Budget()

            try:
                linear = np.asarray(
                    render_image_persistent(
                        scene, cam, pass_cfg, hit_fn=hit_fn,
                        chunk_callback=(on_chunk if chunk_checkpoints
                                        else None),
                        **resume_kw),
                    np.float64)
            except _Budget:
                return None  # chunk budget exhausted; checkpoint saved
        else:
            linear = np.asarray(render_image(scene, cam, pass_cfg,
                                             hit_fn=hit_fn), np.float64)
        accum += linear * spp_pass
        _save(checkpoint_path, accum, p + 1, cfg, passes)
    if end < passes:
        return None  # budget exhausted; resume with another call

    mean = (accum / cfg.samples).astype(np.float32)
    import jax.numpy as jnp
    return np.asarray(tonemap(jnp.asarray(mean)))
