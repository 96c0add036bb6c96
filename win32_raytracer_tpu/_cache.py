"""Persistent XLA compilation cache, shared by every entry point (bench.py,
bench/configs.py, chip_smoke.py, tests/conftest.py, the CLI).

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set,
and otherwise at the fixed ``<checkout>/.jax_cache`` (listed in
.gitignore), so every process of one checkout shares it.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float = 0.2) -> str:
    """Turn the persistent compilation cache on in ``cache_dir()``.

    ``min_compile_secs`` low-bounds which compiles persist — jax's default
    of about 1 s skips the small step programs the renderer dispatches
    most, so entry points pass 0.2 (the tests pass 0.0: their shapes are
    tiny but recur every run).  Returns the directory."""
    import jax

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return d
