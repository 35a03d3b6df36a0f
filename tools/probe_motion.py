#!/usr/bin/env python
"""Motion-blur parity probe vs the rebuilt pbrt-v4 CPU binary.

Renders the same ActiveTransform scene (a quad sweeping left-to-right under
an area light) with the reference binary (per-sample shutter times,
AnimatedPrimitive) and with this renderer (per-wave stratified shutter
times, keyframe-lerped tables), then compares scene mean + 8x8 block means.
The estimators differ only in time stratification, so converged images must
agree.

Usage: python tools/probe_motion.py [--spp 64] [--res 96]
Requires /tmp/refbuild/pbrt (tools/refbuild/assemble.py + make).
"""

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SCENE = """
LookAt 0 1.2 -3.2  0 1.2 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res}] "integer yresolution" [{res}]
    "string filename" "motion.exr"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [14 14 14] "bool twosided" true
  Shape "trianglemesh"
    "point3 P" [-0.8 3.0 -0.8  0.8 3.0 -0.8  0.8 3.0 0.8  -0.8 3.0 0.8]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.8 0.25 0.2]
  ActiveTransform StartTime
  Translate -0.7 0 0
  ActiveTransform EndTime
  Translate 0.7 0 0
  ActiveTransform All
  Shape "trianglemesh"
    "point3 P" [-0.35 0.8 0  0.35 0.8 0  0.35 1.6 0  -0.35 1.6 0]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.45 0.45 0.45]
  Shape "trianglemesh"
    "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--res", type=int, default=96)
    args = ap.parse_args()

    work = "/tmp/motion_probe"
    os.makedirs(work, exist_ok=True)
    scene_file = os.path.join(work, "motion.pbrt")
    with open(scene_file, "w") as f:
        f.write(SCENE.format(res=args.res, spp=args.spp))

    # reference
    subprocess.check_call(["/tmp/refbuild/pbrt", "--nthreads", "2",
                           "motion.pbrt"], cwd=work)
    # ours: rendered by a child; this parent never imports JAX, so the child
    # is the only process on the card
    ours_file = os.path.join(work, "motion_ours.exr")
    subprocess.check_call(
        [sys.executable, "-m", "nn_bvh.cli.render", scene_file,
         "--spp", str(args.spp), "--outfile", ours_file],
        cwd=os.path.join(os.path.dirname(__file__), ".."))

    from nn_bvh.utils import exr

    ref = exr.read_rgb(os.path.join(work, "motion.exr"))
    ours = exr.read_rgb(ours_file)
    mref, mours = float(ref.mean()), float(ours.mean())
    B = 8
    H = (ref.shape[0] // B) * B
    W = (ref.shape[1] // B) * B
    br = ref[:H, :W].reshape(H // B, B, W // B, B, 3).mean((1, 3, 4))
    bo = ours[:H, :W].reshape(H // B, B, W // B, B, 3).mean((1, 3, 4))
    rel = np.abs(bo - br) / np.maximum(br, 0.02)
    print(f"scene mean: ref {mref:.5f} ours {mours:.5f} "
          f"rel {abs(mours - mref) / mref * 100:.2f}%")
    print(f"8x8 block rel err: median {np.median(rel) * 100:.2f}% "
          f"p90 {np.percentile(rel, 90) * 100:.2f}%")
    ok = abs(mours - mref) / mref < 0.025 and np.median(rel) < 0.05
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
