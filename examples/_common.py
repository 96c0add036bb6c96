"""Shared example plumbing: --cpu flag handling.

Must run BEFORE jax initializes a backend: the config update pins the CPU
even when jax was imported earlier."""

import os
import sys

# Examples run from a checkout without installing: put the repo root
# (parent of examples/) ahead on sys.path, so the checkout wins over
# any pip-installed copy.
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))


def maybe_force_cpu(argv=None):
    """Pop --cpu from argv; when present, pin the CPU backend."""
    argv = sys.argv if argv is None else argv
    if "--cpu" in argv:
        argv.remove("--cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
        return True
    return False
