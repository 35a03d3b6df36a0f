"""Curve geometry (geometry/curves.py): dicing fidelity, cyHair import,
parser integration, and a hair-material-on-curves render — the reference's
Curve shape (shapes.h:1219) + cyhair2pbrt converter, diced to ribbons."""

import io
import os
import struct

import numpy as np
import pytest

from nn_bvh.geometry import curves


def test_bezier_eval_endpoints():
    cp = np.array([[0, 0, 0], [1, 0, 0], [2, 1, 0], [3, 1, 1]], np.float32)
    p, t = curves.bezier_eval(cp, np.array([0.0, 1.0], np.float32))
    np.testing.assert_allclose(p[0], cp[0], atol=1e-6)
    np.testing.assert_allclose(p[1], cp[3], atol=1e-6)
    # tangents along the control polygon ends
    assert np.dot(t[0], cp[1] - cp[0]) > 0
    assert np.dot(t[1], cp[3] - cp[2]) > 0


def test_dice_curve_geometry():
    cp = np.array([[0, 0, 0], [0, 1, 0], [0, 2, 0], [0, 3, 0]], np.float32)
    v, f, uv, n = curves.dice_curve(cp, 0.2, 0.1, "flat",
                                    eye=np.array([0, 1.5, 5.0]), n_segments=4)
    assert v.shape == (10, 3) and f.shape == (8, 3)
    # widths: first cross-section 0.2 wide, last 0.1
    assert abs(np.linalg.norm(v[5] - v[0]) - 0.2) < 1e-5
    assert abs(np.linalg.norm(v[9] - v[4]) - 0.1) < 1e-5
    # v-coordinate spans [0,1] across the ribbon (hair h offset)
    assert uv[:5, 1].max() == 0.0 and uv[5:, 1].min() == 1.0
    # ribbon faces the eye: plane normal has positive z toward the camera
    assert np.all(n[:, 2] > 0.5)


def test_dice_multi_span_continuity():
    ctrl = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0],
                     [4, 1, 0], [5, 2, 0], [6, 3, 0]], np.float32)
    v, f, uv, n = curves.dice_curve_spans(ctrl, 0.1, 0.1, "flat",
                                          eye=np.array([0, 0, 5.0]))
    assert len(f) == 2 * 8 * 2  # 2 spans x 8 segments x 2 tris
    assert uv[:, 0].min() == 0.0 and abs(uv[:, 0].max() - 1.0) < 1e-6


def test_bspline_to_bezier_smooth():
    cp = np.array([[0, 0, 0], [1, 0, 0], [2, 1, 0], [3, 1, 0], [4, 0, 0]],
                  np.float32)
    bez = curves.bspline_to_bezier(cp)
    assert len(bez) == 1 + 3 * 2  # 2 spans
    # spans share endpoints (C0) by construction
    p1, _ = curves.bezier_eval(bez[0:4], np.array([1.0], np.float32))
    p2, _ = curves.bezier_eval(bez[3:7], np.array([0.0], np.float32))
    np.testing.assert_allclose(p1, p2, atol=1e-6)


def test_cyhair_roundtrip(tmp_path):
    path = tmp_path / "test.hair"
    n_strands, pts_per = 3, 4
    pts = np.random.RandomState(0).rand(n_strands * pts_per, 3).astype("<f4")
    thick = np.full(n_strands * pts_per, 0.02, "<f4")
    with open(path, "wb") as f:
        f.write(b"HAIR")
        f.write(struct.pack("<IIII", n_strands, len(pts), 1 | 2 | 4, 3))
        f.write(struct.pack("<ff", 0.1, 0.5))
        f.write(struct.pack("<fff", 0.2, 0.1, 0.05))
        f.write(b"\0" * 88)
        f.write(np.full(n_strands, pts_per - 1, "<u2").tobytes())
        f.write(pts.tobytes())
        f.write(thick.tobytes())
    strands = curves.read_cyhair(str(path))
    assert len(strands) == n_strands
    np.testing.assert_allclose(strands[1][0], pts[pts_per:2 * pts_per])
    np.testing.assert_allclose(strands[0][1], 0.02)


def test_curve_scene_parses_and_renders(tmp_path):
    scene = """
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
LookAt 0 0.5 -3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
Integrator "path" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8] "bool twosided" true
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-1 2 -1  1 2 -1  1 2 1  -1 2 1]
AttributeEnd
Material "hair" "float eta" [1.55]
Shape "curve" "string type" "flat"
  "point3 P" [0 0 0  0.05 0.33 0  -0.05 0.66 0  0 1 0]
  "float width0" [0.4] "float width1" [0.3]
"""
    f = tmp_path / "curve.pbrt"
    f.write_text(scene)
    from nn_bvh.geometry import pbrt_parser
    from nn_bvh.wavefront import integrator

    sc, dbvh, cam, res = pbrt_parser.load_scene(str(f))
    assert sc.feat_hair
    assert sc.n_tris >= 16  # diced ribbons + light quad
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, traversal="xla")
    img = np.asarray(integrator.render(sc, dbvh, cam, spp=2,
                                       sampler="independent", cfg=cfg))
    assert np.isfinite(img).all()
    # the curve covers the image center; fibers must scatter some light
    assert img[12:20, 12:20].mean() > 0


def test_bilinearmesh_parses(tmp_path):
    scene = """
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [45]
WorldBegin
Material "diffuse" "rgb reflectance" [0.6 0.2 0.2]
Shape "bilinearmesh"
  "point3 P" [-1 0 2  1 0 2  -1 1 2  1 1.2 2]
  "integer indices" [0 1 2 3]
"""
    f = tmp_path / "blp.pbrt"
    f.write_text(scene)
    from nn_bvh.geometry import pbrt_parser

    sc, dbvh, cam, res = pbrt_parser.load_scene(str(f))
    assert sc.n_tris >= 2
    uv = np.asarray(sc.tri_uv[:2])
    # corner UVs preserved: patch corners p00 p10 p01 p11 -> (0,0),(1,0),(0,1),(1,1)
    assert uv.min() == 0.0 and uv.max() == 1.0
