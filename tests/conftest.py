"""Test configuration.

Pins the CPU backend with a virtual 16-device mesh (a fake backend —
SURVEY.md §4) so shard_map tile assembly and cross-device reductions are
testable without several accelerators, and enables the persistent
compilation cache because XLA compiles are the dominant test cost.

Must set env vars before jax imports — hence module-level, first thing.
Tests that need a GPU carry the ``gpu`` marker and decide inside the
``gpu_device`` fixture whether one is present; under the CPU pin they
skip.  ``WRT_TEST_PLATFORM=gpu`` lifts the pin, which is how
chip_smoke.py runs ``pytest -m gpu`` on the card.
"""

import os
import sys

_PIN_CPU = os.environ.get("WRT_TEST_PLATFORM") != "gpu"
if _PIN_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # 16 virtual devices: most tests run 8-device meshes (devices[:8] are
    # the same objects either way), and the 16-device mesh test needs the
    # headroom.
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=16"
    ).strip()

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import jax  # noqa: E402

if _PIN_CPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() >= 8, (
        "expected the 8-device virtual CPU mesh; got "
        f"{jax.devices()} — XLA_FLAGS was set too late?")
# min 0.0: test shapes are tiny but recur every run.
from win32_raytracer_tpu._cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.0)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]
