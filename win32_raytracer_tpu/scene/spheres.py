"""SoA sphere scene.

The reference already stores spheres as struct-of-arrays for SIMD loads
(``ptr::Spheres``, win32-raytracer/RayTracer.cpp:292-381).  That layout maps
1:1 onto HBM-resident jnp arrays; this module is the device-side version,
with two deliberate fixes over the reference:

* sphere counts are padded to a lane multiple with inactive entries, which
  removes the reference's silent ``size % 8`` sphere dropout
  (RayTracer.cpp:432-434) — padded lanes are masked, not skipped;
* ``reserve``'s double-reserve bug (RayTracer.cpp:363-378) has no analogue.

Negative radii are allowed and meaningful: they flip the geometric normal
(``normal = (hit - center) / radius``, RayTracer.cpp:531-533), which is the
reference's hollow-glass trick (radii -0.5 at RayTracer.cpp:728-744).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from ..core import materials as mat

LANE_PAD = 128  # sphere tile width of the plain sweep (ops/hit.py).


class SphereScene(NamedTuple):
    """Device SoA scene (all arrays have leading dim = padded sphere count).

    Motion-blur spheres interpolate ``center1 -> center2`` over ``[t1, t2]``
    (RayTracer.cpp:449-452); static spheres use t1=0, t2=1, center1==center2
    (RayTracer.cpp:310-331).
    """

    center1: jnp.ndarray   # [S, 3] f32, position at t1
    center2: jnp.ndarray   # [S, 3] f32, position at t2
    t1: jnp.ndarray        # [S] f32
    t2: jnp.ndarray        # [S] f32
    radius: jnp.ndarray    # [S] f32 (signed; negative flips normals)
    mat_id: jnp.ndarray    # [S] int32 (materials.LAMBERTIAN/METAL/DIELECTRIC)
    albedo: jnp.ndarray    # [S, 3] f32
    fuzz: jnp.ndarray      # [S] f32 (metal only)
    ior: jnp.ndarray       # [S] f32 (dielectric only)
    active: jnp.ndarray    # [S] bool — False for padding lanes

    @property
    def padded_size(self) -> int:
        return self.radius.shape[0]


class SceneBuilder:
    """Host-side accumulation API mirroring ``Spheres::add/addMoving``
    (RayTracer.cpp:310-361), finalized into a padded :class:`SphereScene`.
    """

    def __init__(self):
        self._rows = []  # (c1, c2, t1, t2, radius, mat_id, albedo, fuzz, ior)

    def add(self, center, radius, mat_id, albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=1.0):
        """Static sphere: center2 = center1, t in [0, 1] (RayTracer.cpp:310-331)."""
        c = tuple(float(v) for v in center)
        self._rows.append((c, c, 0.0, 1.0, float(radius), int(mat_id),
                           tuple(float(v) for v in albedo), float(fuzz), float(ior)))
        return self

    def add_moving(self, center1, center2, t1, t2, radius, mat_id,
                   albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=1.0):
        """Moving sphere (RayTracer.cpp:333-361).  t1 != t2 required."""
        if t1 == t2:
            raise ValueError("moving sphere requires t1 != t2 (RayTracer.cpp:346)")
        self._rows.append((tuple(float(v) for v in center1),
                           tuple(float(v) for v in center2),
                           float(t1), float(t2), float(radius), int(mat_id),
                           tuple(float(v) for v in albedo), float(fuzz), float(ior)))
        return self

    def add_lambertian(self, center, radius, albedo):
        return self.add(center, radius, mat.LAMBERTIAN, albedo=albedo)

    def add_metal(self, center, radius, albedo, fuzz):
        return self.add(center, radius, mat.METAL, albedo=albedo, fuzz=fuzz)

    def add_dielectric(self, center, radius, ior):
        return self.add(center, radius, mat.DIELECTRIC, ior=ior)

    def __len__(self):
        return len(self._rows)

    def build(self, pad_to: int = LANE_PAD) -> SphereScene:
        n = len(self._rows)
        if n == 0:
            raise ValueError("empty scene")
        padded = max(pad_to, -(-n // pad_to) * pad_to)

        c1 = np.zeros((padded, 3), np.float32)
        c2 = np.zeros((padded, 3), np.float32)
        t1 = np.zeros((padded,), np.float32)
        t2 = np.ones((padded,), np.float32)   # avoid 0/0 in the lerp on pads
        rad = np.zeros((padded,), np.float32)
        mid = np.zeros((padded,), np.int32)
        alb = np.zeros((padded, 3), np.float32)
        fz = np.zeros((padded,), np.float32)
        ior = np.ones((padded,), np.float32)
        act = np.zeros((padded,), bool)

        for i, (a, b, ta, tb, r, m, al, f, io) in enumerate(self._rows):
            c1[i], c2[i], t1[i], t2[i], rad[i] = a, b, ta, tb, r
            mid[i], alb[i], fz[i], ior[i], act[i] = m, al, f, io, True

        # Park padding far away so even a radius-0 degenerate test can't hit.
        c1[n:] = c2[n:] = (0.0, -1.0e8, 0.0)

        return SphereScene(
            center1=jnp.asarray(c1), center2=jnp.asarray(c2),
            t1=jnp.asarray(t1), t2=jnp.asarray(t2), radius=jnp.asarray(rad),
            mat_id=jnp.asarray(mid), albedo=jnp.asarray(alb),
            fuzz=jnp.asarray(fz), ior=jnp.asarray(ior), active=jnp.asarray(act),
        )
