"""CPU rehearsal of chip_smoke.py: it refuses to run without a GPU, and
its comparison helpers do what the chip run relies on."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            pass
    return False


def test_refuses_without_gpu():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_require_gpu_refuses_cpu_device():
    from win32_raytracer_tpu.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu(1)


def test_compare_images_statistics():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
    diff, corr = chip_smoke.compare_images(a, a)
    assert diff == 0.0 and corr == pytest.approx(1.0)
    b = np.clip(a.astype(int) + rng.integers(-2, 3, a.shape), 0, 255)
    diff, corr = chip_smoke.compare_images(a, b)
    assert 0 < diff < 2 and corr > 0.99
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_pair("noise", a, 255 - a, 16)


def test_compare_hits_flags_a_wrong_winner():
    """A record whose winner index is off (no tie, no tangency) fails the
    comparison; the same record compared with itself passes."""
    import jax
    from win32_raytracer_tpu.ops.hit import hit_spheres
    from win32_raytracer_tpu.ops.rows import hit_rows_adapter
    from win32_raytracer_tpu.scene.builders import get_scene
    from win32_raytracer_tpu.scene.camera import default_camera

    scene = get_scene("test")
    o, d, tm = chip_smoke.kernel_rays(default_camera(400, 200), 256)
    ref = jax.jit(hit_rows_adapter(hit_spheres))(scene, o, d, tm)
    assert chip_smoke.compare_hits(scene, ref, ref, o, d, tm)[
        "winner_diffs"] == 0
    hit = np.asarray(ref.hit[0])
    lane = int(np.flatnonzero(hit)[0])
    bad_idx = np.asarray(ref.idx).copy()
    bad_idx[0, lane] = (bad_idx[0, lane] + 1) % 4
    with pytest.raises(AssertionError, match="outside tolerance"):
        chip_smoke.compare_hits(scene, ref, ref._replace(idx=bad_idx),
                                o, d, tm)


@pytest.mark.parametrize("script", ["bench.py", "bench/configs.py",
                                    "bench/hit_ab.py"])
def test_measurement_scripts_refuse_without_gpu(script):
    """The benchmarks never fall back to the CPU: without a GPU they exit
    non-zero and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"value"' not in proc.stdout and '"ok"' not in proc.stdout


def test_nvidia_smi_required(monkeypatch):
    from win32_raytracer_tpu.utils import device

    monkeypatch.setenv("PATH", "")
    with pytest.raises((FileNotFoundError, OSError)):
        device.nvidia_smi()
