#!/usr/bin/env python3
"""Single-material probe renders: OUR renderer vs the pbrt-v4 CPU binary.

The r3 crown-parity hunt showed per-cause probe scenes are the fastest way to
localize spectral/material deviations (BASELINE.md r3: iso + scale-texture
bugs found this way). This tool renders a one-sphere scene with a given
material block under a uniform infinite light with BOTH renderers and prints
scene-mean + center-crop relative error.

Usage:
  python tools/probe_material.py --mat 'Material "coateddiffuse" "rgb reflectance" [.6 .025 .025] "float roughness" [0.010408]'
  python tools/probe_material.py --preset crown-red
  (expects the reference binary at /tmp/refbuild/pbrt; build via tools/refbuild)
"""
import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

PRESETS = {
    # the crown materials named in the r3 close-out as parity suspects
    "crown-red": 'Material "coateddiffuse" "rgb reflectance" [ 0.6 0.025 0.025 ] "float roughness" [ 0.010408 ]',
    "crown-enamel": 'Material "coateddiffuse" "rgb reflectance" [ 0.8 0.8 0.8 ] "float roughness" [ 0.10408 ]',
    "crown-velvet": 'Material "coateddiffuse" "rgb reflectance" [ 0.15 0.0015 0.0015 ] "float roughness" [ 0.2 ]',
    "crown-pearl": 'Material "coateddiffuse" "rgb reflectance" [ 0.65 0.6 0.6 ] "float vroughness" [ 0.001 ] "float uroughness" [ 0.001 ]',
    "white-coated": 'Material "coateddiffuse" "rgb reflectance" [ 1 1 1 ] "float roughness" [ 0.1 ]',
    "diffuse": 'Material "diffuse" "rgb reflectance" [ 0.6 0.025 0.025 ]',
    "gem": 'Material "dielectric" "float eta" [ 3.0 ]',
    "gold": 'Material "conductor" "spectrum eta" [ "metal-Au-eta" ] "spectrum k" [ "metal-Au-k" ] "float roughness" [ 0.1 ]',
}

SCENE = """Integrator "path" "integer maxdepth" [ {maxdepth} ]
Sampler "halton" "integer pixelsamples" [ {spp} ]
Film "rgb" "integer xresolution" [ {res} ] "integer yresolution" [ {res} ]
    "string filename" [ "{out}" ]
LookAt 0 0 4   0 0 0   0 1 0
Camera "perspective" "float fov" [ 30 ]
WorldBegin
LightSource "infinite" "rgb L" [ 1 1 1 ]
{mat}
{shape}
"""


SCENE_TEX = """Integrator "path" "integer maxdepth" [ {maxdepth} ]
Sampler "halton" "integer pixelsamples" [ {spp} ]
Film "rgb" "integer xresolution" [ {res} ] "integer yresolution" [ {res} ]
    "string filename" [ "{out}" ]
LookAt 0 1.0 0   0 0.85 4   0 1 0
Camera "perspective" "float fov" [ 40 ]
WorldBegin
LightSource "infinite" "rgb L" [ 1 1 1 ]
Texture "probe-tex" "spectrum" "imagemap" "string filename" [ "{texfile}" ]
Material "diffuse" "texture reflectance" [ "probe-tex" ]
Shape "trianglemesh"
    "integer indices" [ 0 1 2  0 2 3 ]
    "point3 P" [ -20 0 0   20 0 0   20 0 120   -20 0 120 ]
    "point2 uv" [ 0 0  40 0  40 120  0 120 ]
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mat", help="pbrt Material line")
    ap.add_argument("--textured", metavar="IMG",
                    help="textured receding-plane probe (minification filter "
                         "parity vs the reference MIPMap) with this image")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--maxdepth", type=int, default=5)
    ap.add_argument("--shape",
                    default='Shape "sphere" "float radius" [ 1 ]',
                    help="pbrt Shape line (quadric parity probes)")
    ap.add_argument("--pbrt", default="/tmp/refbuild/pbrt")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    mat = args.mat or PRESETS[args.preset or "crown-red"]

    tmp = tempfile.mkdtemp(prefix="probe_")
    ref_out = os.path.join(tmp, "ref.exr")
    scene_path = os.path.join(tmp, "probe.pbrt")
    with open(scene_path, "w") as f:
        if args.textured:
            texfile = os.path.abspath(args.textured)
            if texfile.endswith((".png", ".jpg", ".jpeg")):
                # the refbuild pbrt has lodepng stubbed out: convert LDR
                # images to linear PFM (sRGB-decoded) for both renderers
                from PIL import Image as _PIL
                import numpy as _np

                raw = _np.asarray(_PIL.open(texfile).convert("RGB"),
                                  _np.float32) / 255.0
                lin = _np.where(raw <= 0.04045, raw / 12.92,
                                ((raw + 0.055) / 1.055) ** 2.4)
                sys.path.insert(0, os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))))
                from nn_bvh.utils import image as _image_mod

                texfile = os.path.join(tmp, "tex.pfm")
                _image_mod.write_pfm(texfile, lin.astype(_np.float32))
            f.write(SCENE_TEX.format(
                texfile=texfile, res=args.res,
                spp=args.spp, maxdepth=args.maxdepth, out=ref_out))
        else:
            f.write(SCENE.format(mat=mat, shape=args.shape, res=args.res,
                                 spp=args.spp, maxdepth=args.maxdepth,
                                 out=ref_out))

    print(f"[probe] {'textured ' + args.textured if args.textured else mat}",
          file=sys.stderr)
    subprocess.run([args.pbrt, "--nthreads", "2", scene_path],
                   check=True, capture_output=True)

    # ours: parse the same scene through the repo pipeline
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nn_bvh.geometry import pbrt_parser
    from nn_bvh.wavefront import integrator as integ
    from nn_bvh.utils import exr as exr_mod

    scene, dbvh, cam, res = pbrt_parser.load_scene(scene_path)
    cfg = integ.IntegratorConfig(max_depth=args.maxdepth)
    img = integ.render(scene, dbvh, cam, spp=args.spp, sampler="halton",
                       cfg=cfg)
    ours = np.asarray(img)

    ref = exr_mod.read_rgb(ref_out)
    assert ref.shape == ours.shape, (ref.shape, ours.shape)

    def stats(name, a, b):
        m = float(np.mean(a)), float(np.mean(b))
        rel = (m[1] - m[0]) / max(m[0], 1e-9)
        print(f"{name}: ref={m[0]:.5f} ours={m[1]:.5f} rel={rel:+.2%}")
        return rel

    stats("scene-mean", ref, ours)
    c = args.res // 4
    stats("sphere-crop", ref[c:-c, c:-c], ours[c:-c, c:-c])
    # background sanity (uniform light seen directly)
    stats("corner-bg", ref[:8, :8], ours[:8, :8])
    if args.keep:
        print("kept:", tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
