"""Render configuration.

Replaces the reference's compile-time constants + mutable globals
(win32-raytracer/pch.h:170-181, set once from the CLI in Main.cpp:73-119)
with an immutable dataclass.  Scene and camera — hard-coded in the reference
(RayTracer.cpp:906-915, 969) — are promoted to first-class arguments of the
render API instead of living here.
"""

from __future__ import annotations

import dataclasses

# Reference defaults (pch.h:170-174).
DEFAULT_IMAGE_WIDTH = 640
DEFAULT_IMAGE_HEIGHT = 480
DEFAULT_NUM_SAMPLES = 50
MAX_RECURSION = 10
DEFAULT_IMAGE_FILENAME = "out.bmp"  # pch.h:183

# Numerical constants of the tracer core.
EPSILON = 1e-5          # normal offset, RayTracer.cpp:13
MIN_HIT_T = 0.001       # near-t threshold, RayTracer.cpp:430
REFLECT_THRES = 0.05    # dielectric reflect bias, RayTracer.cpp:661
SHUTTER_OPEN_T = 0.0    # camera defaults, RayTracer.cpp:233-234
SHUTTER_CLOSE_T = 0.05


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) renderer parameters.

    ``match_reference`` toggles reproduction of the reference's numerical
    quirks; production mode uses the textbook formulas:

    * ``refract_discriminant_bias``: the reference computes the refraction
      discriminant as ``2.0 - n^2 (1 - dt^2)`` instead of the textbook
      ``1.0 - ...`` (RayTracer.cpp:168) — this visibly changes the glass.
    * ``schlick_uses_ni_over_nt``: Schlick is called with ``ni_over_nt``
      rather than the material IOR (RayTracer.cpp:658).
    * ``reflect_thres``: the reflect decision is
      ``0.05 + r < probability`` (RayTracer.cpp:661-662), biasing away from
      reflection.  Set >= 1.05 to make dielectrics deterministic refractors
      (used by exact golden tests).
    """

    width: int = DEFAULT_IMAGE_WIDTH
    height: int = DEFAULT_IMAGE_HEIGHT
    samples: int = DEFAULT_NUM_SAMPLES
    max_depth: int = MAX_RECURSION  # depth > max_depth returns black (RayTracer.cpp:399-402)
    seed: int = 0

    # Quirk toggles (all default to reference behavior for image parity).
    refract_discriminant_bias: float = 2.0
    schlick_uses_ni_over_nt: bool = True
    reflect_thres: float = REFLECT_THRES

    # Numerics.
    epsilon: float = EPSILON
    min_hit_t: float = MIN_HIT_T

    # Deterministic mode: every uniform draw becomes 0.5 (pixel centers, no
    # lens/time jitter, fixed dielectric decision).  With specular-only
    # scenes this makes renders exactly comparable against the native oracle
    # (tests/test_golden.py); mirrors oracle `deterministic`.
    deterministic: bool = False

    # Optional Russian-roulette path termination (extension; the reference
    # terminates only on miss / metal absorb / depth, SURVEY.md §7).
    russian_roulette: bool = False
    rr_start_depth: int = 3

    # Execution knobs.
    # Sphere hit sweep: "pallas" = the GPU kernel (kernels/hit_triton.py),
    # "jnp" = the plain XLA sweep (ops/hit.py), "auto" = by platform
    # (kernels/dispatch.py).
    backend: str = "auto"       # "auto" | "pallas" | "jnp"
    # Acceleration structure: "grid" sweeps a triangle mesh through its
    # Morton-tiled grid (tri_accel.py); "auto" and "off" keep the brute
    # sweeps (the reference's behavior, RayTracer.cpp:433-551).  Sphere
    # scenes have no grid path: "grid" on one raises.
    accel: str = "auto"         # "auto" | "grid" | "off"
    # Per-bounce spatial sort of the path state (persistent scheduler)
    # so the triangle grid's per-block tile unions stay tight on bounce
    # batches (persistent._bin_sort).  "auto" = on for scenes carrying a
    # TriGridScene; "on" errors without one; "off" disables.  Permutes
    # lanes like compaction does: images match unbinned renders
    # statistically, not bitwise.
    ray_binning: str = "auto"   # "auto" | "on" | "off"
    # Work redistribution at above-floor compactions: overshoot the
    # compacted size so spare dead lanes adopt donors' unstarted samples
    # (halved sequential tails for hard pixels).  "auto" = off.
    redistribute: str = "auto"  # "auto" | "on" | "off"
    # Triangle-grid tile granularity (triangles per Morton tile).  0 =
    # auto (tri_accel.build_tri_grid's default).
    tri_tile_rows: int = 0
    # Triangle-grid ray-block granularity (lanes per block whose segment
    # boxes are unioned for the tile mask).  0 = auto (512).
    tri_ray_block: int = 0
    # Triangle-grid tile partition: "morton" cuts a space-filling curve
    # of the centroids; "median" recursively median-splits the widest
    # axis (tri_accel._median_split_order).  "auto" = morton.
    tri_partition: str = "auto"  # "auto" | "morton" | "median"
    # Two-phase triangle pass (kernels/tri_rebin.py): sphere pass first,
    # then the triangle working set is sorted by an occlusion-CAPPED
    # chord key before the grid sweep and unsorted after.  Replaces
    # driver-level ray binning when on; state lanes are never permuted,
    # so results match rebin-off exactly (cross-tile tie rule aside).
    # "dda" (kernels/tri_dda.py) expands lanes into the macro cells their
    # capped chord visits (fixed K slots) and sorts the pair list by
    # cell.  "auto" = off.
    tri_rebin: str = "auto"  # "auto" | "on" | "dda" | "off"
    # Pair slots per lane for tri_rebin="dda" (kernels/tri_dda.py
    # k_max).  0 = the default (4).
    tri_dda_k: int = 0
    # Wavefront chunk size (lanes in flight per chunk).  4M lanes hold
    # about 280 MB of path state: one chunk covers 1200x800 at 4 lanes
    # per pixel.
    rays_per_chunk: int = 1 << 22

    # Scheduler: "wavefront" = one lane per (pixel, sample), fixed
    # max_depth+1 bounce steps (simple, but lanes idle once their path
    # ends); "persistent" = one lane per pixel, samples run sequentially
    # with immediate respawn on path termination (~3x less wasted work on
    # the RTIOW scene); "auto" picks persistent when samples >= 8.
    scheduler: str = "auto"
    # Persistent scheduler: steps between host-side all-done checks (each
    # check costs one device sync).  The loop backs off to a 32-step
    # cadence when the alive count plateaus or the batch is below the
    # compaction floor; an explicit value above 32 raises that back-off
    # cap too.
    check_period: int = 0  # 0 = auto
    # One-shot chunk rendering (persistent scheduler): run a whole lane
    # chunk to completion inside ONE jitted program — a lax.while_loop
    # whose body is the one-program bounce and whose condition is "any
    # lane alive" — instead of the host-driven check/compact loop.  Small
    # renders are dispatch-bound, and below the compaction floor the host
    # loop has no compaction decisions left to make anyway.  Results
    # match sequential dispatches bitwise; vs the host driver they match
    # until its first split/compaction re-keys lane draws (statistically
    # equivalent after that).
    # "auto" = whole-chunk while_loops only, for chunks that start at or
    # below the compaction floor, when no feature that needs the host
    # loop BETWEEN steps is active (ray binning / tri rebin).
    # "on" = whole-chunk AND a tail finisher for above-floor chunks (the
    # host loop compacts normally and hands its below-floor tail to the
    # while_loop program), raising on a conflict instead of falling back.
    # "off" always uses the host loop.  "staged" = a staged device-side
    # tail (persistent.p_render_until): below the floor, each stage is
    # one while_loop that exits when the alive count reaches the
    # floor-pow2 of half the width, then the host performs that one
    # compact+split and re-enters; each stage size compiles its own
    # program.  Same conflicts as "on".
    one_shot: str = "auto"  # "auto" | "on" | "off" | "staged"
    # Tail multi-bounce width: bounces per dispatched program once a
    # chunk is at/below the compaction floor (persistent.
    # p_bounce_multi_step, and the shard_mapped twin in
    # parallel/persistent_shard._steps).  Bigger K = fewer dispatches, at
    # the cost of a larger compile and up to K-1 wasted bounces after
    # the last lane dies.  0 = auto (4).
    multi_k: int = 0
    # Compaction size grid quantum (persistent scheduler): >0 rounds
    # above-floor compactions up to a multiple of this ABSOLUTE quantum
    # (rung sizes then depend on runtime alive counts, so every new
    # seed/config compiles never-seen step programs).  0 = auto: the
    # seed-independent RELATIVE (mantissa) grid — 16 sizes per
    # power-of-two octave, a fixed enumerable rung set shared by all
    # seeds/configs/image shapes (persistent._mantissa_grid).
    compact_quantum: int = 0
    # Above-floor compaction trigger: compact when the next grid size is
    # <= this fraction of the current batch.  0.0 = auto (0.90); range
    # (0, 1).
    compact_shrink: float = 0.0
    # Compaction engine: "sort" = the 20-operand stable lax.sort
    # (_compact_core); "route" = the bit-serial stable-partition router
    # (persistent._compact_route_core) — same surviving-lane slots (the
    # continuing render is bit-identical), no sort network; retained-dead
    # lanes become synthesized zero-quota padding and the dropped-tail
    # flush is an unsorted segment_sum.  "" = auto ("sort").
    # Receiver-redistribution events (cfg.redistribute="on") always use
    # the sort engine.
    compactor: str = ""
    # Dropped-tail flush engine at compactions: "scatter" = XLA
    # segment_sum; "window" = dense windowed accumulation of the
    # pixel-sorted stream (block one-hot matrix product +
    # dynamic-update-slice, sparse-block scatter fallback under lax.cond
    # — persistent._window_flush).  "" = auto ("scatter").
    flush_mode: str = ""
    # Persistent scheduler: replica lanes per pixel (samples split across
    # K lanes with quota spp/K each — more parallelism for hard pixels,
    # shorter sequential tails, bigger batches).  0 = auto (largest of
    # 8/4/2 dividing spp with quota >= 4).  Must divide samples.
    lanes_per_pixel: int = 0
    # Difficulty-adaptive lane allocation (persistent scheduler,
    # adaptive.py): a quota-1 prepass (lanes_per_pixel samples) measures
    # per-pixel path length, then the remaining samples run on lanes
    # allocated proportional to measured difficulty — hard pixels get
    # more lanes with smaller quotas.  Requires a single-frame unbinned
    # render with samples > lanes_per_pixel.  Opt-in; "off" is the
    # default.
    adaptive_alloc: str = "off"   # "off" | "on"
    # Transform the prepass difficulty estimate before allocation:
    # max(raw, 3x3 box mean)^1.2 — the box term hedges single-pixel
    # underestimates, the max keeps hard pixels hard, and the mild
    # super-proportional exponent counters regression-to-mean under
    # predictor noise.  Single-chip driver only.  "auto" = off.
    adaptive_pool: str = "auto"   # "auto" | "on" | "off"
    # Soft cap on adaptive lanes per pixel (hard cap: remaining samples).
    kpp_max: int = 32

    # Stratified pixel jitter: samples placed on a sqrt(spp) grid within
    # the pixel instead of pure uniform (extension; reduces variance,
    # BASELINE.json config 3).
    stratify: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def resolve_scheduler(cfg: RenderConfig, samples: int | None = None) -> str:
    """The scheduler "auto" rule, shared by render.render, animation
    batching, and checkpoint pass decomposition (which resolves on the
    PER-PASS spp): the persistent scheduler earns its compaction
    machinery at >= 8 samples; deterministic renders stay on the
    fixed-step wavefront."""
    if cfg.scheduler != "auto":
        return cfg.scheduler
    spp = cfg.samples if samples is None else samples
    return ("persistent"
            if spp >= 8 and not cfg.deterministic else "wavefront")
