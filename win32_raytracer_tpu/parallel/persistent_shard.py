"""Multi-chip persistent wavefront scheduler (shard_map over a 1-D mesh).

The single-chip production renderer (persistent.py) sharded over devices:
every step program (hit / scatter+respawn / compaction / sample-splitting)
is lane-local, so each becomes one shard_map over the
lane axis and the Python driver loop stays identical — one host loop
drives D devices in SPMD.

Work assignment mirrors the reference's interleaved-block thread scheduler
(win32-raytracer/RayTracer.cpp:973-978): device b owns image row-blocks
b, b+D, b+2D, ..., so every device works the same mix of easy (sky) and
hard (glass/ground) regions and per-shard alive counts stay balanced —
which matters here because compaction is per-shard SPMD: all shards
compact to the same size, chosen from the *maximum* per-shard alive count.

Radiance accumulates into a per-device partial image ([D, 3, H*W],
device-sharded); the single cross-device reduction is one sum at the end —
the cross-device analogue of the reference's disjoint imageParts slots + final
stitch (Game.cpp:94-102).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from .. import persistent as _P
from ..persistent import (
    PathState, _COMPACT_FLOOR, _COMPACT_SHRINK, _MULTI_K, _bin_sort_core,
    _tri_rebin_active,
    _compact_core, _compact_route_core, _derive_bin_box,
    _exact_divmod_any, _grid_size,
    _hit_core, _next_pow2,
    _resolve_kpp, _respawn_core, _scatter_core, _split, make_dims,
    step_cfg,
)
from ..scene.camera import Camera, default_camera
from ..scene.spheres import SphereScene

_STATE_ROWS = {"origin": 3, "direction": 3, "time": 1, "throughput": 3,
               "radiance_sum": 3, "depth": 1, "sample": 1, "pixel": 1,
               "path_alive": 1, "s_base": 1, "s_quota": 1}


def _sspec():
    return PathState(*(P(None, "tiles") for _ in PathState._fields))


@functools.lru_cache(maxsize=64)
def _steps(mesh: Mesh, cfg: RenderConfig, hit_fn, n_frames: int = 1,
           mk: int = _MULTI_K, lean: bool = False):
    """Shard-mapped step programs for one (mesh, NORMALIZED config) —
    cached so jitted closures are reused across chunks, frames, seeds,
    and (since dims ride as a traced operand) image sizes and every
    driver knob.  ``cfg`` must be persistent.step_cfg(cfg); ``mk`` is the
    tail multi-bounce width.

    Every returned program takes ``dims`` (persistent.make_dims, traced
    i32[8], replicated) right after the step index, and ``cam`` is the
    (frame-stacked, for multi-frame batches) Camera."""
    sspec = _sspec()
    kspec = P("tiles")  # per-device [D] draw-salt array

    def bounce(scene, cam, st, salts, step_i, dims):
        salt = salts[0]
        rec, st = _hit_core(scene, st, cfg=cfg, hit_fn=hit_fn)
        st = _scatter_core(scene, st, rec, salt, step_i, dims,
                           cfg=cfg, lean=lean)
        return _respawn_core(cam, st, salt, step_i, dims, cfg=cfg,
                             n_frames=n_frames, lean=lean)

    # check_vma=False: hit_fn may be a pallas kernel, whose
    # ShapeDtypeStruct outputs carry no varying-mesh-axes annotation.
    bounce_sm = jax.jit(jax.shard_map(
        bounce, mesh=mesh, in_specs=(P(), P(), sspec, kspec, P(), P()),
        out_specs=sspec, check_vma=False))

    # Tail multi-bounce program (persistent.p_bounce_multi_step sharded):
    # below the per-shard dispatch floor the render is dispatch-bound, so
    # cfg.multi_k (auto 4, via ``mk``) full bounces ride ONE shard_map
    # dispatch.  Draws are bit-identical to mk successive bounce_sm calls.
    def bounce_multi(scene, cam, st, salts, step0, dims):
        salt = salts[0]

        def body(i, st):
            step_i = step0 + i
            rec, st2 = _hit_core(scene, st, cfg=cfg, hit_fn=hit_fn)
            st2 = _scatter_core(scene, st2, rec, salt, step_i, dims,
                                cfg=cfg, lean=lean)
            return _respawn_core(cam, st2, salt, step_i, dims, cfg=cfg,
                                 n_frames=n_frames, lean=lean)

        return jax.lax.fori_loop(0, mk, body, st)

    multi_sm = jax.jit(jax.shard_map(
        bounce_multi, mesh=mesh, in_specs=(P(), P(), sspec, kspec, P(), P()),
        out_specs=sspec, check_vma=False))

    def first_respawn(cam, st, salts, dims):
        return _respawn_core(cam, st, salts[0], jnp.int32(0), dims,
                             cfg=cfg, n_frames=n_frames, lean=lean)

    respawn_sm = jax.jit(jax.shard_map(
        first_respawn, mesh=mesh, in_specs=(P(), sspec, kspec, P()),
        out_specs=sspec))

    def alive_counts(st):
        return jnp.sum(st.path_alive, dtype=jnp.int32).reshape(1)

    alive_sm = jax.jit(jax.shard_map(
        alive_counts, mesh=mesh, in_specs=(sspec,), out_specs=P("tiles")))

    def flush_all(st, accum, kpp_t):
        # accum: per-device partial [1, 3, HW] slice of the [D, 3, HW] array.
        pix, _ = _exact_divmod_any(st.pixel[0], kpp_t)
        add = jax.ops.segment_sum(
            st.radiance_sum.T, pix, num_segments=accum.shape[2])
        return accum + add.T[None]

    flush_sm = jax.jit(jax.shard_map(
        flush_all, mesh=mesh,
        in_specs=(sspec, P("tiles", None, None), P()),
        out_specs=P("tiles", None, None)))

    # One-shot tail finisher (persistent.p_render_oneshot, sharded):
    # run the batch TO COMPLETION in one shard-local while_loop per
    # device.  Each shard's condition reads only its own lanes, so
    # shards desynchronize freely (no lockstep alive checks, no
    # per-dispatch floor) and the program has no collectives to
    # deadlock on.  step0/max_s ride as traced scalars so one compiled
    # program serves every chunk and the adaptive phase-2 rerun.
    def oneshot_finish(scene, cam, st, salts, step0, max_s, dims):
        salt = salts[0]

        def cond(carry):
            st_, s_ = carry
            return (s_ < max_s) & jnp.any(st_.path_alive)

        def body(carry):
            st_, s_ = carry
            s_ = s_ + 1
            rec, st_ = _hit_core(scene, st_, cfg=cfg, hit_fn=hit_fn)
            st_ = _scatter_core(scene, st_, rec, salt, s_, dims, cfg=cfg,
                                lean=lean)
            st_ = _respawn_core(cam, st_, salt, s_, dims, cfg=cfg,
                                n_frames=n_frames, lean=lean)
            return st_, s_

        st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(step0)))
        return st

    finish_sm = jax.jit(jax.shard_map(
        oneshot_finish, mesh=mesh,
        in_specs=(P(), P(), sspec, kspec, P(), P(), P()),
        out_specs=sspec, check_vma=False))

    # Staged tail stage (persistent.p_render_until, sharded): each
    # shard bounces in its OWN while_loop until its local alive count
    # reaches ``target`` (or max_s), then returns (state, exit step,
    # alive count) per shard — shards desynchronize freely between the
    # host's lockstep compact+split events, and the only host traffic
    # per stage is the one (steps, counts) fetch.  Do-while: the first
    # bounce is unconditional (just-split clone lanes sit dead until a
    # respawn revives them).  The host re-enters every shard at the MAX
    # exit step so no shard ever repeats a draw index (skipped indices
    # are merely unconsumed).
    def until_stage(scene, cam, st, salts, step0, target, max_s, dims):
        salt = salts[0]

        def body(carry):
            st_, s_ = carry
            s_ = s_ + 1
            rec, st_ = _hit_core(scene, st_, cfg=cfg, hit_fn=hit_fn)
            st_ = _scatter_core(scene, st_, rec, salt, s_, dims, cfg=cfg,
                                lean=lean)
            st_ = _respawn_core(cam, st_, salt, s_, dims, cfg=cfg,
                                n_frames=n_frames, lean=lean)
            return st_, s_

        def cond(carry):
            st_, s_ = carry
            alive = jnp.sum(st_.path_alive, dtype=jnp.int32)
            return (s_ < max_s) & (alive > target)

        st, s = jax.lax.while_loop(cond, body, body((st, jnp.int32(step0))))
        return (st, s.reshape(1),
                jnp.sum(st.path_alive, dtype=jnp.int32).reshape(1))

    until_sm = jax.jit(jax.shard_map(
        until_stage, mesh=mesh,
        in_specs=(P(), P(), sspec, kspec, P(), P(), P(), P()),
        out_specs=(sspec, P("tiles"), P("tiles")), check_vma=False))

    return (bounce_sm, alive_sm, flush_sm, respawn_sm, multi_sm,
            finish_sm, until_sm)


@functools.lru_cache(maxsize=64)
def _bin_sort_sm(mesh: Mesh, box, key_variant: str):
    """Per-shard ray binning (persistent._bin_sort sharded): each shard
    multisorts its OWN lanes by chord bucket — no cross-shard traffic.
    Shard-local order is all the block-schedule mask needs (the tri-grid
    kernel's ray blocks are per-shard), and binned renders run the
    compactor with tail_sorted=False (state_sorted gates it off), so the
    permutation costs nothing downstream."""
    sspec = _sspec()

    def sort(st):
        return _bin_sort_core(st, box=box, key_variant=key_variant)

    return jax.jit(jax.shard_map(
        sort, mesh=mesh, in_specs=(sspec,), out_specs=sspec))


@functools.lru_cache(maxsize=256)
def _compact_split_sm(mesh: Mesh, kpp: int, k_new: int, do_split: bool,
                      tail_sorted: bool = False, compactor: str = "sort",
                      flush: str = "scatter"):
    sspec = _sspec()

    def compact(st, accum):
        # Shared compactor engine (persistent._compact_core, or the
        # bit-serial router _compact_route_core — identical
        # surviving-lane layout, no sort network; see the single-chip
        # rationale).  tail_sorted: each shard's lane->pixel map starts
        # ASCENDING by construction (_interleaved_pixel_lanes sorts its
        # lanes — order within a shard is free, only set membership
        # load-balances), so above-floor compactions take the
        # argsort-free flush path the single-chip driver uses; bin sorts
        # and splits disable it.  The router needs neither flag.
        if compactor == "route":
            new, acc2 = _compact_route_core(
                st, accum[0], k_new=k_new, lanes_per_pixel=kpp)
        else:
            new, acc2 = _compact_core(
                st, accum[0], k_new=k_new, lanes_per_pixel=kpp,
                tail_sorted=tail_sorted, flush=flush)
        accum = acc2[None]
        if do_split:
            new = _split(new)
        return new, accum

    return jax.jit(jax.shard_map(
        compact, mesh=mesh,
        in_specs=(sspec, P("tiles", None, None)),
        out_specs=(sspec, P("tiles", None, None))))


def _interleaved_pixel_lanes(h: int, w: int, kpp: int, d: int,
                             block_rows: int = 8) -> np.ndarray:
    """[D, lanes_per_dev] pixel-lane ids: device b owns row-blocks
    b, b+D, b+2D, ... (reference interleaving, RayTracer.cpp:979-981).
    Rows are padded to a multiple of block_rows*D by wrapping: wrapped
    lanes re-render existing pixels' lane ids with zero quota (inactive).
    """
    n_blocks = -(-h // block_rows)
    pad_blocks = (-n_blocks) % d
    blocks = np.arange(n_blocks + pad_blocks) % n_blocks  # wrap pads
    per_dev = []
    for b in range(d):
        rows = []
        for blk in blocks[b::d]:
            r0 = blk * block_rows
            rows.extend(range(r0, min(r0 + block_rows, h)))
            # short last block: wrap rows to keep shard sizes equal
            rows.extend(range(0, max(0, r0 + block_rows - h)))
        lanes = (np.asarray(rows)[:, None] * w * kpp
                 + np.arange(w * kpp)[None, :]).reshape(-1)
        # Ascending within the shard: intra-shard ORDER is free (only set
        # membership load-balances), and ascending pixel-lane ids let the
        # sharded compactor run the argsort-free tail_sorted flush path.
        per_dev.append(np.sort(lanes))
    return np.stack(per_dev).astype(np.int32)


def render_image_persistent_sharded(
    scene: SphereScene,
    cam,
    cfg: RenderConfig,
    mesh: Mesh,
    hit_fn=None,
) -> jnp.ndarray:
    """Persistent-scheduler render over the mesh; linear [H, W, 3] f32.

    Multi-frame batching (the single-chip contract, persistent.py:550-553,
    sharded): pass a LIST of cameras as ``cam`` to render len(cam)
    animation frames as ONE virtual F*height-tall image whose interleaved
    row-blocks shard over the mesh — scheduler tail, alive-check syncs,
    and the per-shard dispatch floor amortize over all frames AND all
    devices.  Returns [F, H, W, 3]."""
    cams = None
    n_frames = 1
    if isinstance(cam, (list, tuple)) and not isinstance(cam, Camera):
        cams = list(cam)
        n_frames = len(cams)
        if n_frames == 1:
            # Singleton batch (odd tail of an even frame split): plain
            # single-camera render; only the [1, H, W, 3] return
            # contract remembers the list-ness (persistent.py ditto).
            cam = cams[0]
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    if hit_fn is None:
        # May swap the scene for its triangle grid (replicated across
        # shards).  The backend follows the MESH devices' platform, not
        # the default device's.
        from ..kernels.dispatch import get_hit_fn_rows_accel
        scene, hit_fn = get_hit_fn_rows_accel(
            cfg, scene, cams[0] if cams else cam,
            platform=mesh.devices.flat[0].platform)
    # Ray binning (per shard): same policy as the single-chip driver.
    bin_box = _derive_bin_box(cfg, scene)
    if cfg.compact_quantum < 0:
        # Same guard as the single-chip driver: a negative quantum makes
        # _grid_size round DOWN, silently dropping live lanes.
        raise ValueError(f"compact_quantum must be >= 0 (0 = auto), got "
                         f"{cfg.compact_quantum}")
    if not (cfg.compact_shrink == 0.0 or 0.0 < cfg.compact_shrink < 1.0):
        raise ValueError(f"compact_shrink must be 0 (auto) or in (0, 1), "
                         f"got {cfg.compact_shrink}")
    shrink = cfg.compact_shrink or _COMPACT_SHRINK
    compactor_s = cfg.compactor or "sort"
    flush_s = cfg.flush_mode or "scatter"
    w, h, spp = cfg.width, cfg.height, cfg.samples
    h_virt = h * n_frames  # multi-frame: frames stack as a taller image
    if n_frames > 1:
        # Step programs consume a frame-stacked Camera ([F]-leading fields).
        camt = Camera(*(jnp.stack([jnp.asarray(getattr(c, f), jnp.float32)
                                   for c in cams])
                        for f in Camera._fields))
    else:
        camt = cam
    d = mesh.devices.size
    kpp = _resolve_kpp(cfg, spp, n_frames, w * h)
    quota = spp // kpp
    adaptive = cfg.adaptive_alloc == "on"
    if adaptive and not (kpp > 1 and spp > kpp and bin_box is None):
        # Mirror the single-chip gate (persistent.py): with ray binning
        # active the prepass's bin sorts permute shard lanes every step,
        # so the est reshape would attribute path lengths to the wrong
        # pixels — silently inverting the feature's win.
        raise ValueError(
            "adaptive_alloc='on' needs an unbinned render with "
            "lanes_per_pixel > 1 and samples > lanes_per_pixel "
            f"(got kpp={kpp}, samples={spp}, "
            f"ray_binning={'active' if bin_box else 'off'})")
    if cfg.adaptive_pool == "on":
        # The pooled-estimate transform needs the chunk's contiguous
        # (rows, width) layout; a shard's interleaved row-block pixel
        # set would pool across rows 8 apart.  Refuse rather than
        # silently measuring the raw estimate.
        raise ValueError("adaptive_pool='on' is single-chip only")
    seed = cfg.seed
    check_period = cfg.check_period or 8
    first_check = quota + 2
    max_steps = (quota + 1) * (cfg.max_depth + 2)
    min_lanes = 1 << 10
    floor = max(_COMPACT_FLOOR // d, min_lanes)
    # Step programs take the NORMALIZED config + traced dims (see
    # persistent.py): one compiled set per (mesh, lane count) serves
    # every image size, seed, and driver knob.
    scfg = step_cfg(cfg)
    # Static lean flag (persistent.py rationale): strat/RR compiled out
    # of the step programs when this render cannot use them.
    lean = not (cfg.stratify and spp > 1) and not cfg.russian_roulette
    mk = cfg.multi_k or _MULTI_K
    if h_virt * w * kpp >= (1 << 29):
        # Same bound as the single-chip driver: the XLA cores' f32
        # reciprocal divmod decode is exact below 2^29.
        raise ValueError(
            f"pixel-lane ids must stay below 2^29 "
            f"(width*height*frames*lanes_per_pixel = {h_virt * w * kpp})")
    # One-shot tail finisher (single-chip semantics, persistent.py): at
    # or below the per-shard floor, hand the rest of the batch to one
    # shard-local while_loop per device.  Conflicts mirror the
    # single-chip driver: per-period bin sorts and triangle working-set
    # sorts need the host loop between steps.
    one_shot = cfg.one_shot
    if one_shot not in ("auto", "on", "off", "staged"):
        raise ValueError(
            f"one_shot must be auto|on|off|staged, got {one_shot!r}")
    _os_conflicts = [name for hit, name in (
        (bin_box is not None, "ray binning"),
        (_tri_rebin_active(cfg, scene), "tri_rebin working-set sorts"),
    ) if hit]
    if one_shot in ("on", "staged") and _os_conflicts:
        raise ValueError(f"one_shot={one_shot!r} conflicts with "
                         + ", ".join(_os_conflicts))
    if one_shot == "auto":
        # "chunk": whole-batch while_loops only; the above-floor tail
        # finisher needs explicit "on" (see persistent.py).
        one_shot = "off" if _os_conflicts else "chunk"

    lanes = _interleaved_pixel_lanes(h_virt, w, kpp, d)  # [D, n_local]
    n_local = lanes.shape[1]
    # Pad each shard onto the compaction size grid (_grid_size), exactly
    # like the single-chip chunk padding: every sharded render then
    # STARTS at a ladder lane count the compile cache already owns.  The
    # filler columns duplicate existing lane ids, so the wrap-dedup
    # below zeroes their quotas; re-sorting keeps the per-shard
    # ascending order the tail_sorted flush relies on.
    # (Not under adaptive: its prepass relies on contiguous kpp-lane
    # groups per pixel, which the padding re-sort would interleave.)
    pad_l = _grid_size(n_local, min_lanes, cfg.compact_quantum) - n_local
    if pad_l and not adaptive:
        fill = lanes[:, np.arange(pad_l) % n_local]
        lanes = np.sort(np.concatenate([lanes, fill], axis=1), axis=1)
        n_local += pad_l
    n = d * n_local
    # Wrapped padding lanes (duplicate pixel ids) get zero quota.  The
    # dedupe must be first-occurrence-aware WITHIN a shard too: when the
    # short last row-block wraps rows 0..k and lands on the shard that
    # also owns block 0 ((n_blocks-1) % d == 0 with h % block_rows != 0),
    # both copies of a lane id sit in the same lanes[b] — a vectorized
    # ~first_seen[lanes[b]] read marks BOTH fresh and those pixels
    # render 2x their samples (divided by spp once: over-bright rows).
    first_seen = np.zeros(h_virt * w * kpp, bool)
    quota_np = np.zeros((d, n_local), np.int32)
    for b in range(d):
        uniq, first_idx = np.unique(lanes[b], return_index=True)
        fresh = np.zeros(n_local, bool)
        fresh[first_idx] = ~first_seen[uniq]
        first_seen[uniq] = True
        quota_np[b] = np.where(fresh, quota, 0)

    spec = jax.NamedSharding(mesh, P(None, "tiles"))
    pix = jax.device_put(lanes.reshape(1, n), spec)
    q0 = jax.device_put(quota_np.reshape(1, n), spec)

    def row(v, rows_):
        return jax.device_put(
            jnp.broadcast_to(jnp.float32(v), (rows_, n)), spec)

    st = PathState(
        origin=row(0.0, 3),
        direction=jax.device_put(
            jnp.broadcast_to(jnp.asarray([[0.0], [0.0], [1.0]], jnp.float32),
                             (3, n)), spec),
        time=row(0.0, 1),
        throughput=row(1.0, 3),
        radiance_sum=row(0.0, 3),
        depth=jax.device_put(jnp.zeros((1, n), jnp.int32), spec),
        sample=jax.device_put(jnp.full((1, n), -1, jnp.int32), spec),
        pixel=pix,
        path_alive=jax.device_put(jnp.zeros((1, n), bool), spec),
        s_base=jax.device_put(
            (jnp.asarray(lanes.reshape(1, n)) % kpp) * quota, spec),
        s_quota=q0,
    )
    accum = jax.device_put(jnp.zeros((d, 3, h_virt * w), jnp.float32),
                           jax.NamedSharding(mesh, P("tiles", None, None)))

    # Per-device draw salts (hash_uniform01 counters; purpose tags split
    # the scatter/respawn streams inside the step cores).
    dev_keys = np.asarray(
        [(seed * 0x9E3779B1 ^ (b + 1) * 0x85EBCA77) & 0xFFFFFFFF
         for b in range(d)], np.uint32)                  # [D] salts
    dev_keys = jax.device_put(dev_keys, jax.NamedSharding(mesh, P("tiles")))

    def make_driver(kpp_s, dev_keys_s):
        """do_steps + the check/compact/split loop bound to one lane
        encoding (kpp_s) and per-device salt set."""
        (bounce_sm, alive_sm, flush_sm, respawn_sm, multi_sm,
         finish_sm, until_sm) = _steps(mesh, scfg, hit_fn,
                                       n_frames=n_frames, mk=mk, lean=lean)
        dims_s = make_dims(cfg, w, h, spp, kpp_s)

        def do_steps(st, k, step):
            # Tail economics mirror the single-chip driver: at or below
            # the per-shard floor the render is dispatch-bound, so
            # cfg.multi_k bounces ride one shard_map dispatch each.
            # Binned scenes take single steps everywhere: a multi-bounce
            # program would run bounces 2..K on bins gone stale after
            # one scatter.
            cur = st.pixel.shape[1] // d
            if cur <= floor and bin_box is None:
                while k >= mk:
                    st = multi_sm(scene, camt, st, dev_keys_s,
                                  jnp.int32(step + 1), dims_s)
                    step += mk
                    k -= mk
            for _ in range(k):
                step += 1
                if bin_box is not None and (step - 1) % _P._BIN_PERIOD == 0:
                    # _BIN_KEY read per call: flipping the module global
                    # rebuilds (lru key) instead of reusing a stale trace.
                    st = _bin_sort_sm(mesh, bin_box, _P._BIN_KEY)(st)
                st = bounce_sm(scene, camt, st, dev_keys_s,
                               jnp.int32(step), dims_s)
            return st, step

        def staged_tail(st, accum, step, max_steps_s):
            """Staged device-side tail, sharded (one_shot='staged'):
            per-shard while_loops that exit at the exact alive-halving
            point (persistent.make_staged semantics), lockstep
            compact+split between stages sized by the worst shard.
            Shards desync inside a stage; the host re-enters at the MAX
            exit step so no shard repeats a draw index."""
            while step < max_steps_s:
                cur = st.pixel.shape[1] // d
                if cur <= 2 * min_lanes:
                    st = finish_sm(scene, camt, st, dev_keys_s,
                                   jnp.int32(step), jnp.int32(max_steps_s),
                                   dims_s)
                    break
                target = 1 << (max(cur // 2, 1).bit_length() - 1)
                st, stp, cnt = until_sm(
                    scene, camt, st, dev_keys_s, jnp.int32(step),
                    jnp.int32(target), jnp.int32(max_steps_s), dims_s)
                step = int(np.asarray(stp).max())
                worst = int(np.asarray(cnt).max())
                if worst == 0 or step >= max_steps_s:
                    break
                k_new = max(min_lanes, _next_pow2(worst))
                st, accum = _compact_split_sm(
                    mesh, kpp_s, k_new, True,
                    compactor=compactor_s,
                    flush=flush_s)(st, accum)
            return st, accum

        def run_loop(st, accum, first_check_s, max_steps_s,
                     state_sorted=False):
            step = 0
            # Whole-batch one-shot: a batch that STARTS at/below the
            # per-shard floor never compacts, so skip the host loop
            # entirely (the single-chip chunk-level shortcut, sharded).
            if one_shot == "staged" and st.pixel.shape[1] // d <= floor:
                return staged_tail(st, accum, 0, max_steps_s)
            if one_shot in ("on", "chunk") and st.pixel.shape[1] // d <= floor:
                st = finish_sm(scene, camt, st, dev_keys_s, jnp.int32(0),
                               jnp.int32(max_steps_s), dims_s)
                return st, accum
            period = check_period
            last_alive = n
            while step < max_steps_s:
                next_check = (first_check_s if step < first_check_s
                              else step + period)
                st, step = do_steps(
                    st, min(next_check, max_steps_s) - step, step)
                cur = st.pixel.shape[1] // d
                # Overlapped alive check (persistent.py): dispatch the
                # counts, hide the fetch round trip behind a few
                # optimistic steps, then read.  Counts are stale-but-
                # upper-bound (monotone non-increasing), so termination
                # and compaction sizing stay correct.
                cnt = alive_sm(st)
                try:
                    cnt.copy_to_host_async()
                except Exception:
                    pass
                ov = 1 if cur >= (1 << 21) else (
                    2 if cur >= (1 << 20) else 4)
                st, step = do_steps(st, min(ov, max_steps_s - step), step)
                counts = np.asarray(cnt)                 # [D]
                worst = int(counts.max())
                if counts.sum() == 0:
                    break
                # (an explicit cfg.check_period above 32 raises the
                # tail back-off cap too — the rarer-checks A/B knob)
                if cur < floor:
                    period = max(32, check_period)
                elif worst > 0.9 * last_alive:
                    period = min(period * 2, max(32, check_period))
                else:
                    period = check_period
                last_alive = worst
                if cur <= floor:
                    if one_shot == "staged":
                        st, accum = staged_tail(st, accum, step,
                                                max_steps_s)
                        break
                    if one_shot == "on":
                        # One-shot tail: compact+split once if it would
                        # fire anyway, then finish every shard in one
                        # device-side while_loop — no further host round
                        # trips or lockstep alive checks.
                        k_new = max(min_lanes, _next_pow2(worst))
                        if k_new <= cur // 2:
                            st, accum = _compact_split_sm(
                                mesh, kpp_s, k_new, True,
                                compactor=compactor_s,
                                flush=flush_s)(st, accum)
                        st = finish_sm(scene, camt, st, dev_keys_s,
                                       jnp.int32(step),
                                       jnp.int32(max_steps_s), dims_s)
                        break
                    k_new = max(min_lanes, _next_pow2(worst))
                    if k_new <= cur // 2:
                        st, accum = _compact_split_sm(
                            mesh, kpp_s, k_new, True,
                            compactor=compactor_s,
                            flush=flush_s)(st, accum)
                        state_sorted = False  # split clones break order
                    continue
                k_new = _grid_size(worst, min_lanes, cfg.compact_quantum)
                if k_new <= int(cur * shrink):
                    st, accum = _compact_split_sm(
                        mesh, kpp_s, k_new, False,
                        tail_sorted=state_sorted,
                        compactor=compactor_s,
                        flush=flush_s)(st, accum)
            return st, accum

        # Bind dims/kpp so call sites keep the historical signatures.
        def respawn0(cam_, st_, keys_):
            return respawn_sm(cam_, st_, keys_, dims_s)

        def flush(st_, accum_):
            return flush_sm(st_, accum_, jnp.int32(kpp_s))

        return do_steps, run_loop, flush, respawn0

    do_steps, run_loop, flush_sm, respawn_sm = make_driver(kpp, dev_keys)

    if adaptive:
        # Phase 1 (prepass): quota-1 on every fresh lane (0 on wrap
        # pads); every path dies within max_depth+1 bounces, so the
        # phase is a STATIC step count with zero device syncs, and the
        # uncompacted final depth row is the per-sample path length in
        # lane-identity order.
        st = st._replace(
            s_base=jax.device_put(
                jnp.asarray(lanes.reshape(1, n)) % kpp, spec),
            s_quota=jax.device_put(
                (quota_np.reshape(1, n) > 0).astype(np.int32), spec))
        st = respawn_sm(camt, st, dev_keys)
        st, _ = do_steps(st, cfg.max_depth + 1, 0)
        accum = flush_sm(st, accum)

        # Phase 2: per-shard difficulty-proportional lanes over the
        # shard's own interleaved pixel set (adaptive.alloc_lanes with
        # explicit pixel ids; wrap pads carry q_rest=0).
        from ..adaptive import alloc_lanes

        n_local_pix = n_local // kpp
        pix_ids_np = (lanes[:, ::kpp] // kpp).astype(np.int32)
        q_rest_np = ((quota_np[:, ::kpp] > 0) * (spp - kpp)).astype(
            np.int32)
        pspec = jax.NamedSharding(mesh, P(None, "tiles"))
        pix_ids = jax.device_put(pix_ids_np.reshape(1, -1), pspec)
        q_rest = jax.device_put(q_rest_np.reshape(1, -1), pspec)

        def build_phase2(st1, pix_ids_, q_rest_):
            est = jnp.sum(st1.depth[0].reshape(n_local_pix, kpp), axis=1)
            pix2, s_base2, s_quota2 = alloc_lanes(
                est, n_lanes=n_local, spp_done=kpp, spp=spp,
                kpp_max=cfg.kpp_max, pixel_ids=pix_ids_[0],
                q_rest=q_rest_[0])
            z1 = jnp.zeros((1, n_local), jnp.float32)
            z3 = jnp.zeros((3, n_local), jnp.float32)
            return PathState(
                origin=z3,
                direction=z3.at[2, :].set(1.0),
                time=z1,
                throughput=jnp.ones((3, n_local), jnp.float32),
                radiance_sum=z3,
                depth=jnp.zeros((1, n_local), jnp.int32),
                sample=jnp.full((1, n_local), -1, jnp.int32),
                pixel=pix2,
                path_alive=jnp.zeros((1, n_local), bool),
                s_base=s_base2,
                s_quota=s_quota2,
            )

        # check_vma=False: the fresh state rows are constants (not
        # varying over tiles), which strict shard_map would reject for
        # tiled out_specs.
        build_sm = jax.jit(jax.shard_map(
            build_phase2, mesh=mesh,
            in_specs=(_sspec(), P(None, "tiles"), P(None, "tiles")),
            out_specs=_sspec(), check_vma=False))
        st = build_sm(st, pix_ids, q_rest)

        dev_keys2 = np.asarray(
            [(int(k) * 0x85EBCA77 + 0x632BE5AB) & 0xFFFFFFFF
             for k in np.asarray(dev_keys)], np.uint32)
        dev_keys2 = jax.device_put(
            dev_keys2, jax.NamedSharding(mesh, P("tiles")))
        _, run_loop2, flush2_sm, respawn2_sm = make_driver(1, dev_keys2)
        st = respawn2_sm(camt, st, dev_keys2)
        spp_rest = spp - kpp
        st, accum = run_loop2(
            st, accum,
            spp_rest // min(cfg.kpp_max, spp_rest) + 2,
            (spp_rest + 1) * (cfg.max_depth + 2))
        accum = flush2_sm(st, accum)
    else:
        st = respawn_sm(camt, st, dev_keys)  # start sample 0 on all lanes
        # tail_sorted flushes: per-shard pixel-lane ids start ascending
        # by construction; ray binning re-permutes every period, and the
        # composite sort key needs every id below the pixel ceiling.
        st, accum = run_loop(
            st, accum, first_check, max_steps,
            state_sorted=(bin_box is None
                          and h_virt * w * kpp < int(_P._SORT_PIX_LIM)))
        accum = flush_sm(st, accum)

    total = jnp.sum(accum, axis=0)      # [3, HW]: one cross-device reduction
    out = (total / spp).T.reshape(h_virt, w, 3)
    if cams is not None:
        return out.reshape(n_frames, h, w, 3)
    return out
