"""pbrt --format / --upgrade / --toply analog (cli/format.py;
FormattingParserTarget, parser.h:202).

Round-trip gate: formatting a vendored scene and re-parsing it must produce
the same compiled geometry/materials as parsing the original.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from nn_bvh.cli import format as fmt
from nn_bvh.geometry import pbrt_parser

KILLEROO = "/root/reference/scenes/killeroos/killeroo-simple-v4.pbrt"


@pytest.mark.skipif(not os.path.exists(KILLEROO), reason="no reference scenes")
def test_format_roundtrip_killeroo():
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "formatted.pbrt")
        fmt.main([KILLEROO, "-o", out])
        # includes are relative to the scene file: keep cwd semantics by
        # copying the formatted file next to the original's geometry
        import shutil

        shutil.copytree(os.path.dirname(KILLEROO),
                        os.path.join(td, "scene"))
        out2 = os.path.join(td, "scene", "formatted.pbrt")
        shutil.copy(out, out2)
        sc0, _, cam0, res0 = pbrt_parser.load_scene(KILLEROO)
        sc1, _, cam1, res1 = pbrt_parser.load_scene(out2)
        assert sc1.n_tris == sc0.n_tris
        assert sc1.n_lights == sc0.n_lights
        assert res1.spp == res0.spp and res1.integrator == res0.integrator
        # triangle SETS must match (leaf order may differ after each build)
        a = np.sort(np.asarray(sc0.tri_p)[: sc0.n_tris].reshape(-1, 9), axis=0)
        b = np.sort(np.asarray(sc1.tri_p)[: sc1.n_tris].reshape(-1, 9), axis=0)
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_upgrade_v3_names():
    src = """
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
WorldBegin
Material "matte" "color Kd" [0.5 0.4 0.3]
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
Material "glass" "float index" [1.8] "color Kr" [1 1 1]
Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
"""
    stmts = fmt.parse_statements(fmt.tokenize(src))
    up = [fmt.upgrade_statement(s) for s in stmts]
    text = fmt.format_statements(up)
    assert '"diffuse"' in text and '"matte"' not in text
    assert '"rgb reflectance"' in text and "Kd" not in text
    assert '"dielectric"' in text and '"float eta"' in text
    assert "Kr" not in text
    assert '"paddedsobol"' in text
    assert 'Film "rgb"' in text


def test_toply_extraction():
    # 128-triangle fan -> extracted to a .ply and replaced by plymesh
    import math

    nv = 130
    P = [0.0, 0.0, 0.0]
    for i in range(nv - 1):
        a = i / (nv - 2) * math.pi
        P += [math.cos(a), math.sin(a), 0.0]
    I = []
    for i in range(nv - 2):
        I += [0, i + 1, i + 2]
    src = ('WorldBegin\nShape "trianglemesh" "point3 P" [ '
           + " ".join(f"{x:g}" for x in P)
           + ' ] "integer indices" [ ' + " ".join(map(str, I)) + " ]\n")
    with tempfile.TemporaryDirectory() as td:
        scene = os.path.join(td, "s.pbrt")
        open(scene, "w").write(src)
        out = os.path.join(td, "s_fmt.pbrt")
        fmt.main([scene, "-o", out, "--toply", os.path.join(td, "geo")])
        text = open(out).read()
        assert '"plymesh"' in text and '"trianglemesh"' not in text
        plys = os.listdir(os.path.join(td, "geo"))
        assert len(plys) == 1
        # re-parse: same triangle count through the ply reader
        sc, _, _, _ = pbrt_parser.load_scene(out)
        assert sc.n_tris == nv - 2
