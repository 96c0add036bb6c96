"""Tracing / profiling helpers.

The reference's observability is wall-clock only (high_resolution_clock
around the render, win32-raytracer/RayTracer.cpp:967/1006-1007, plus PIX
GPU markers, Game.cpp:207/265).  The equivalents here:

* :class:`PhaseTimer` — named wall-clock phases with device sync, the
  per-stage timing the reference lacks;
* :func:`trace` — a ``jax.profiler`` trace context writing a TensorBoard-
  loadable profile (the PIX-marker analogue);
* :func:`mrays` — throughput from ray counts + seconds (the BASELINE.json
  metric).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    """Accumulates wall-clock per named phase (device-synced boundaries)."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._sync = sync

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                # Drain the dispatch queue so the phase owns its real cost.
                jax.effects_barrier()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = [
            f"{name:>16s}: {t:8.3f}s ({100 * t / total:5.1f}%)"
            f" x{self.counts[name]}"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def mrays(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6
