"""Random number generation.

Two tiers, mirroring the capability split in the reference
(win32-raytracer/RayTracer.cpp):

1. ``ReferenceLcg`` — an exact, bit-faithful reproduction of the reference's
   SIMD "fast rand" (RayTracer.cpp:31-58, Intel Pentium-4 fast-rand LCG).
   The reference seeds every ``ThreadContext`` with 666 (RayTracer.cpp:27),
   so scene generation (RayTracer.cpp:768-891) is fully deterministic.  We
   reproduce the stream exactly so our scene builders lay out *identical*
   spheres/materials to the C++ renderer, and so tests can validate against
   a native oracle.

2. Production renderer RNG — counter-based ``jax.random`` (threefry) keys,
   folded per bounce, giving per-lane i.i.d. draws that are reproducible,
   parallel-safe, and cheap on any device.  This intentionally *improves on* the
   reference, which reuses seed 666 for every thread and tile (a visible
   repeated-noise quirk, RayTracer.cpp:27, 903).

LCG semantics (derived from the intrinsics in RayTracer.cpp:31-58): the
``_mm_mul_epu32`` shuffle dance reduces to four independent 32-bit LCG lanes

    s0' = s0 * 214013 + 2531011
    s1' = s1 *  17405 + 10395331
    s2' = s2 * 214013 + 13737667
    s3' = s3 *  69069 + 1        (all mod 2**32)

with initial state (seed+1, seed, seed+1, seed) from
``_mm_set_epi32(seed, seed+1, seed, seed+1)`` (RayTracer.cpp:63-66), and
float conversion ``r_i = (float(int32(s_i)) / 2^31 + 1) * 0.5`` in [0, 1)
(RayTracer.cpp:49-53; the divisor is ``cvtepi32_ps(INT_MAX)`` which rounds
to 2^31 in f32).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# Per-lane LCG multipliers/adders (RayTracer.cpp:33-34, after the epu32
# shuffle algebra collapses to scalar lanes).
_LCG_MUL = np.array([214013, 17405, 214013, 69069], dtype=np.uint32)
_LCG_ADD = np.array([2531011, 10395331, 13737667, 1], dtype=np.uint32)

#: 2^31 as f32 — what ``_mm_cvtepi32_ps(INT_MAX)`` actually evaluates to.
_F_MAX = np.float32(2147483648.0)


def lcg_init_state(seed: int = 666) -> np.ndarray:
    """Initial 4-lane state for the reference LCG (RayTracer.cpp:63-66)."""
    s = np.uint32(seed)
    return np.array([s + 1, s, s + 1, s], dtype=np.uint32)


def lcg_step(state: np.ndarray) -> np.ndarray:
    """One LCG step over the 4 lanes (uint32 wraparound)."""
    return (state * _LCG_MUL + _LCG_ADD).astype(np.uint32)


def lcg_floats(state: np.ndarray) -> np.ndarray:
    """Convert lane state to the 4 floats in [0,1) (RayTracer.cpp:49-53)."""
    as_i32 = state.view(np.int32) if state.dtype == np.uint32 else state
    return ((as_i32.astype(np.float32) / _F_MAX) + np.float32(1.0)) * np.float32(0.5)


class ReferenceLcg:
    """Stateful host-side reproduction of ``ptr::ThreadContext::rand_sse``.

    Each :meth:`rand4` call advances the state once and returns the 4-float
    vector the reference stores to ``result`` (RayTracer.cpp:55).
    """

    def __init__(self, seed: int = 666):
        self.state = lcg_init_state(seed)

    def rand4(self) -> np.ndarray:
        self.state = lcg_step(self.state)
        return lcg_floats(self.state)

    def stream(self, n_calls: int) -> np.ndarray:
        """Return the next ``n_calls`` rand4 vectors as an [n_calls, 4] array."""
        out = np.empty((n_calls, 4), dtype=np.float32)
        for i in range(n_calls):
            out[i] = self.rand4()
        return out


def lcg_step_jnp(state: jnp.ndarray) -> jnp.ndarray:
    """Batched jnp LCG step: state [..., 4] uint32 -> [..., 4] uint32."""
    return state * jnp.asarray(_LCG_MUL) + jnp.asarray(_LCG_ADD)


def lcg_floats_jnp(state: jnp.ndarray) -> jnp.ndarray:
    """Batched jnp float conversion matching :func:`lcg_floats`."""
    as_i32 = jax.lax.bitcast_convert_type(state, jnp.int32)
    return ((as_i32.astype(jnp.float32) / _F_MAX) + 1.0) * 0.5


# ---------------------------------------------------------------------------
# Production renderer draws (analytic samplers; replaces the reference's
# rejection loops RayTracer.cpp:187-216 which are SIMT/SPMD-hostile).
# ---------------------------------------------------------------------------


def uniform01(key: jax.Array, shape) -> jnp.ndarray:
    """U[0,1) f32 draws."""
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def _fmix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3's 32-bit finalizer (full avalanche)."""
    x = (x ^ (x >> 16)) * jnp.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform01(shape, salt: jnp.ndarray, step: jnp.ndarray,
                   purpose: int) -> jnp.ndarray:
    """Counter-based U[0,1) f32 draws, [rows, N], via double fmix32.

    A ~14-int-op/draw replacement for threefry on the per-step hot path
    (the persistent scheduler draws 10 uniforms/lane/step; threefry was a
    measurable slice of the scatter+respawn step).  The counter is
    (salt, step, row, lane): ``salt`` is a per-chunk/per-shard uint32
    scalar array (an argument, so one compiled program serves every
    chunk and shard), ``purpose`` a compile-time stream
    tag.  Each (step, lane) pair is visited once per chunk, so draws never
    repeat along a path; two fmix32 rounds with distinct offsets give full
    avalanche between consecutive counters — ample for Monte-Carlo
    sampling (the reference reused one LCG stream seeded 666 for every
    tile, RayTracer.cpp:27).
    """
    rows, n = shape
    lane = jax.lax.broadcasted_iota(jnp.uint32, (rows, n), 1)
    row = jax.lax.broadcasted_iota(jnp.uint32, (rows, n), 0)
    s = _fmix32(step.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
                ^ salt.astype(jnp.uint32) ^ jnp.uint32(purpose))
    x = _fmix32(lane ^ _fmix32(s + row * jnp.uint32(0x85EBCA6B)))
    return (x >> 8).astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def sample_unit_ball(u: jnp.ndarray) -> jnp.ndarray:
    """Map u[..., 3] uniforms to points uniform in the unit ball.

    Analytic replacement for ``getRandomPointInUnitSphere``
    (RayTracer.cpp:187-200): identical distribution, no rejection loop.
    """
    z = 1.0 - 2.0 * u[..., 0]
    phi = (2.0 * jnp.pi) * u[..., 1]
    r = jnp.cbrt(u[..., 2])
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * s * jnp.cos(phi), r * s * jnp.sin(phi), r * z], axis=-1)


def sample_unit_disc(u: jnp.ndarray) -> jnp.ndarray:
    """Map u[..., 2] uniforms to points uniform on the unit disc (z=0).

    Analytic replacement for ``getRandomPointOnUnitDisc``
    (RayTracer.cpp:203-216).
    """
    r = jnp.sqrt(u[..., 0])
    theta = (2.0 * jnp.pi) * u[..., 1]
    return jnp.stack(
        [r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1
    )
