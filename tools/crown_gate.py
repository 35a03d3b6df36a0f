#!/usr/bin/env python
"""Render the crown north-star artifact on the GPU and gate it.

1. Stages /tmp/crown_golden (PFM textures; tools/refbuild/crown_golden.py)
2. Renders 250x350@64spp volpath (same config as the pbrt-v4 CPU golden)
3. Prints the gate numbers (scene-mean rel err, block median/p90)
4. On pass, copies the render to data/golden/crown-ours-volpath-250x350-64spp.exr
   so tests/test_crown_golden.py::test_crown_artifact_parity gates it in CI.

Usage: python tools/crown_gate.py [--spp 64] [--no-copy]
"""

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "data", "golden", "crown-volpath-250x350-64spp.exr")
OURS_TMP = "/tmp/crown_ours.exr"
OURS_REPO = os.path.join(REPO, "data", "golden",
                         "crown-ours-volpath-250x350-64spp.exr")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--no-copy", action="store_true")
    ap.add_argument("--use-existing", action="store_true",
                    help="gate an already-rendered /tmp/crown_ours.exr")
    args = ap.parse_args()

    if not args.use_existing or not os.path.exists(OURS_TMP):
        if not os.path.exists("/tmp/crown_golden/crown_golden.pbrt"):
            subprocess.check_call(
                [sys.executable, os.path.join(REPO, "tools", "refbuild",
                                              "crown_golden.py")])
        # the render runs in a child; this parent never imports JAX, so the
        # child is the only process on the card
        subprocess.check_call(
            [sys.executable, "-m", "nn_bvh.cli.render",
             "/tmp/crown_golden/crown_golden.pbrt",
             "--spp", str(args.spp), "--outfile", OURS_TMP, "--stats"],
            cwd=REPO)

    from nn_bvh.utils import exr
    from tests.test_crown_golden import _downsample

    ours = exr.read_rgb(OURS_TMP)
    gold = exr.read_rgb(GOLDEN)
    g = _downsample(gold, 10, 7)
    o = _downsample(ours, 10, 7)
    rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
    denom = np.maximum(g.mean(-1), 0.05 * g.mean())
    blockrel = np.abs(o.mean(-1) - g.mean(-1)) / denom
    print(f"scene mean: ours {o.mean():.5f} pbrt {g.mean():.5f} rel {rel:.3%}")
    print(f"block rel err: median {np.median(blockrel):.3%} "
          f"p90 {np.percentile(blockrel, 90):.3%} max {blockrel.max():.3%}")
    ok = rel < 0.05 and np.median(blockrel) < 0.10 \
        and (blockrel < 0.35).mean() > 0.85
    print("GATE:", "PASS" if ok else "FAIL")
    if ok and not args.no_copy:
        shutil.copy(OURS_TMP, OURS_REPO)
        print("copied ->", OURS_REPO)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
