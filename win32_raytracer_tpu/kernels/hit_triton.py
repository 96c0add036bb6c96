"""Nearest sphere hit as a Pallas kernel for NVIDIA GPUs (Triton route).

The plain sweep (ops/hit.py) builds several [N, 128] float32 arrays per
128-sphere tile; at a few million lanes each one is gigabytes of device
memory traffic for about 25 flops per ray-sphere pair.  This kernel keeps
that work in registers: one program per block of ``block`` ray lanes loads
its rays once, loops over the sphere table with the running
``(best t, best index)`` carried in registers, and writes 8 bytes per lane.
The table ([S, 16] f32, a few tens of KB) is read by every program and
stays in L1/L2.  The winner's attributes are fetched after the kernel by
one gather, which XLA fuses into the hit-record epilogue.

Semantics are those of ``ops.hit.hit_spheres`` (the reference's AVX sweep,
win32-raytracer/RayTracer.cpp:433-589): near root only, ``disc >= 0``,
``t > min_t``, inactive (padding) spheres masked, motion-blur lerp of the
centre, signed radius.  The sweep runs in index order with a strict
``<``, so exact ties keep the lowest index, like the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import MIN_HIT_T
from ..ops.hit import (
    F32_MAX, _attr_matrix,
    _A_C1X, _A_C1Y, _A_C1Z, _A_DCX, _A_DCY, _A_DCZ, _A_T1, _A_INVDT,
    _A_RADIUS, _A_IDX,
)
from ..ops.rows import HitRecordRows, assemble_hit_record_rows
from ..scene.spheres import SphereScene

# Lanes per program and warps per program, chosen on an H100 at the
# final scene's full chunk width (PERF.md, "Sphere-hit kernel").
DEFAULT_BLOCK = 512
DEFAULT_NUM_WARPS = 2


def _sweep_kernel(o_ref, d_ref, tm_ref, tab_ref, t_ref, i_ref, *,
                  n, n_spheres, min_t, block):
    """rays: o/d [3, N], tm [1, N]; tab [S, 16] (ops.hit._attr_matrix
    layout, the idx column replaced by the active flag); outputs t [N]
    f32 (F32_MAX = miss) and winner index [N] i32 (0 on a miss)."""
    lane = pl.program_id(0) * block + jnp.arange(block)
    m = lane < n

    def ld(ref, row, other):
        return plgpu.load(ref.at[row, lane], mask=m, other=other)

    ox, oy, oz = ld(o_ref, 0, 0.0), ld(o_ref, 1, 0.0), ld(o_ref, 2, 0.0)
    dx, dy, dz = ld(d_ref, 0, 0.0), ld(d_ref, 1, 0.0), ld(d_ref, 2, 1.0)
    tm = ld(tm_ref, 0, 0.0)
    a = dx * dx + dy * dy + dz * dz

    def body(s, carry):
        best_t, best_i = carry
        lerp = (tm - tab_ref[s, _A_T1]) * tab_ref[s, _A_INVDT]
        cx = tab_ref[s, _A_C1X] + tab_ref[s, _A_DCX] * lerp
        cy = tab_ref[s, _A_C1Y] + tab_ref[s, _A_DCY] * lerp
        cz = tab_ref[s, _A_C1Z] + tab_ref[s, _A_DCZ] * lerp
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b_half = dx * ocx + dy * ocy + dz * ocz
        r = tab_ref[s, _A_RADIUS]
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_half * b_half - a * c
        t = (-b_half - jnp.sqrt(jnp.maximum(disc, 0.0))) / a
        valid = (disc >= 0.0) & (t > min_t) & (tab_ref[s, _A_IDX] > 0.5)
        better = valid & (t < best_t)
        return (jnp.where(better, t, best_t),
                jnp.where(better, s, best_i))

    init = (jnp.full((block,), F32_MAX, jnp.float32),
            jnp.zeros((block,), jnp.int32))
    best_t, best_i = jax.lax.fori_loop(0, n_spheres, body, init)
    plgpu.store(t_ref.at[lane], best_t, mask=m)
    plgpu.store(i_ref.at[lane], best_i, mask=m)


@functools.partial(jax.jit, static_argnames=(
    "min_t", "block", "num_warps", "interpret"))
def sphere_sweep(origin, direction, time, table, *, min_t, block,
                 num_warps, interpret=False):
    """Raw kernel call: (t [N], winner index [N]) for rows-layout rays
    against a kernel table (see ``kernel_table``)."""
    n = origin.shape[1]
    kernel = functools.partial(_sweep_kernel, n=n,
                               n_spheres=table.shape[0], min_t=min_t,
                               block=block)
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32)),
        grid=(pl.cdiv(n, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="sphere_hit_sweep",
    )(origin, direction, time, table)


def kernel_table(scene: SphereScene) -> jnp.ndarray:
    """The packed [S, 16] attribute matrix with its idx column replaced
    by the active flag (the kernel needs no index column: the loop
    counter is the index)."""
    return _attr_matrix(scene).at[:, _A_IDX].set(
        scene.active.astype(jnp.float32))


def hit_spheres_triton(
    scene: SphereScene,
    origin: jnp.ndarray,     # [3, N]
    direction: jnp.ndarray,  # [3, N]
    time: jnp.ndarray,       # [1, N]
    min_t: float = MIN_HIT_T,
    block: int = DEFAULT_BLOCK,
    num_warps: int = DEFAULT_NUM_WARPS,
    interpret: bool = False,
) -> HitRecordRows:
    """Rows-layout nearest-hit sweep (ops.rows hit-function interface)."""
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    t, idx = sphere_sweep(origin, direction, time, kernel_table(scene),
                          min_t=float(min_t), block=block,
                          num_warps=num_warps, interpret=interpret)
    t, idx = t[None], idx[None]
    hit = t < F32_MAX
    gt = jnp.where(hit, jnp.take(_attr_matrix(scene).T, idx[0], axis=1),
                   0.0)
    return assemble_hit_record_rows(origin, direction, time, t, gt)
