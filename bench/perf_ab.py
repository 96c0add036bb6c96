#!/usr/bin/env python
"""A/B perf-regression harness — the perfTest.bat analogue.

The reference's harness (/root/reference/perfTest.bat:1-26) stashes the
working tree, builds+times the previous revision, restores, builds+times
the current one, and leaves ``prevPerf.txt`` / ``currPerf.txt`` for a human
diff.  This does the same with git worktrees and the framework's perf mode
(160x120 @ 10 spp, the reference's regression unit — perfTest.bat:4), and
prints a machine-readable comparison.

Usage:
  python bench/perf_ab.py [--base REV] [--config 160x120x10] [--scene random]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def run_perf(tree: str, cfg: str, scene: str, platform: str) -> dict:
    w, h, s = cfg.split("x")
    with tempfile.NamedTemporaryFile(suffix=".txt") as tf:
        cmd = [sys.executable, "-m", "win32_raytracer_tpu.cli",
               w, h, s, "1", "perfTest",
               "--scene", scene, "--perf-file", tf.name, "--quiet"]
        if platform:
            cmd += ["--platform", platform]
        env = dict(os.environ)
        env["PYTHONPATH"] = tree + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                             text=True, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="HEAD~1",
                    help="revision to compare against (default HEAD~1)")
    ap.add_argument("--config", default="160x120x10",
                    help="WxHxSPP regression unit (reference: 160x120x10)")
    ap.add_argument("--scene", default="random")
    ap.add_argument("--platform", default="",
                    help="force jax platform (cpu for smoke runs)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        base_tree = os.path.join(tmp, "base")
        subprocess.run(["git", "-C", REPO, "worktree", "add", "--detach",
                        base_tree, args.base], check=True,
                       capture_output=True)
        try:
            prev = run_perf(base_tree, args.config, args.scene, args.platform)
            curr = run_perf(REPO, args.config, args.scene, args.platform)
        finally:
            subprocess.run(["git", "-C", REPO, "worktree", "remove",
                            "--force", base_tree], capture_output=True)

    # The prevPerf.txt / currPerf.txt analogues (perfTest.bat:18, 26).
    with open(os.path.join(REPO, "prevPerf.txt"), "w") as f:
        f.write(f"{prev['wall_ms']}\n")
    with open(os.path.join(REPO, "currPerf.txt"), "w") as f:
        f.write(f"{curr['wall_ms']}\n")

    speedup = prev["wall_ms"] / curr["wall_ms"] if curr["wall_ms"] else 0.0
    print(json.dumps({
        "base": args.base, "config": args.config,
        "prev_ms": prev["wall_ms"], "curr_ms": curr["wall_ms"],
        "speedup": round(speedup, 3),
        "regression": speedup < 0.95,
    }))
    return 1 if speedup < 0.95 else 0


if __name__ == "__main__":
    sys.exit(main())
