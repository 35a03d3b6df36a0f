"""Parser / PLY / loop-subdivision / transform / image-IO tests
(reference analogs: parser_test.cpp, util/image_test.cpp)."""

import numpy as np
import pytest

from nn_bvh.geometry import pbrt_parser, ply, loopsubdiv, transform as xf
from nn_bvh.utils import image as image_mod


class TestTokenizer:
    def test_basic(self):
        toks = list(pbrt_parser.tokenize('Shape "sphere" "float radius" [ 3 ] # c\nWorldBegin'))
        assert toks == ["Shape", '"sphere"', '"float radius"', "[", "3", "]", "WorldBegin"]

    def test_params(self):
        ts = pbrt_parser.TokenStream('"float fov" [ 39 ] "rgb L" [1 2 3] "integer n" 5 Next', is_file=False)
        p = pbrt_parser.parse_params(ts)
        assert p["fov"]["values"] == [39.0]
        assert p["L"]["values"] == [1.0, 2.0, 3.0]
        assert p["n"]["values"] == [5]
        assert ts.next() == "Next"


class TestParser:
    def test_minimal_scene(self, tmp_path):
        f = tmp_path / "s.pbrt"
        f.write_text(
            """
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [32] "integer yresolution" [24]
Sampler "halton" "integer pixelsamples" [8]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.4 0.5 0.6]
  Shape "trianglemesh" "point3 P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
LightSource "point" "rgb I" [10 10 10] "point3 from" [0 3 -1]
"""
        )
        res = pbrt_parser.parse_file(str(f))
        sc = res.builder.build()
        assert sc.n_tris == 2
        assert sc.n_lights == 1
        assert (res.width, res.height, res.spp) == (32, 24, 8)
        assert res.integrator == "path" and res.max_depth == 3
        # camera at (0,0,-5) looking at origin
        np.testing.assert_allclose(res.cam_to_world[:3, 3], [0, 0, -5], atol=1e-5)
        d = res.cam_to_world[:3, :3] @ np.array([0, 0, 1.0])
        np.testing.assert_allclose(d, [0, 0, 1], atol=1e-5)

    def test_attribute_stack_restores_material(self, tmp_path):
        f = tmp_path / "s.pbrt"
        f.write_text(
            """
Camera "perspective"
WorldBegin
Material "diffuse" "rgb reflectance" [0.9 0.1 0.1]
AttributeBegin
  Material "conductor" "float roughness" [0.2]
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
AttributeEnd
Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
"""
        )
        res = pbrt_parser.parse_file(str(f))
        sc = res.builder.build()
        mats = np.asarray(sc.tri_mat[: sc.n_tris])
        types = np.asarray(sc.mat_type)
        assert types[mats[0]] == 1  # conductor
        assert types[mats[1]] == 0  # diffuse restored

    def test_killeroo_parses(self):
        res = pbrt_parser.parse_file(
            "/root/reference/scenes/killeroos/killeroo-simple-v4.pbrt"
        )
        sc = res.builder.build()
        assert sc.n_tris > 50000  # two subdivided killeroos + walls
        assert res.fov == 39.0
        assert (res.width, res.height) == (700, 700)
        assert sc.n_lights > 0

    def test_object_instancing(self, tmp_path):
        f = tmp_path / "s.pbrt"
        f.write_text(
            """
Camera "perspective"
WorldBegin
Material "diffuse"
ObjectBegin "tri"
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
ObjectEnd
ObjectInstance "tri"
Translate 5 0 0
ObjectInstance "tri"
"""
        )
        res = pbrt_parser.parse_file(str(f))
        sc = res.builder.build()
        assert sc.n_tris == 2
        p = np.asarray(sc.tri_p[: sc.n_tris])
        assert abs(p[1, :, 0].mean() - p[0, :, 0].mean() - 5.0) < 1e-5


class TestPLY:
    def test_ascii_roundtrip(self, tmp_path):
        f = tmp_path / "m.ply"
        f.write_text(
            "ply\nformat ascii 1.0\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 2\nproperty list uchar int vertex_indices\n"
            "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n3 0 1 2\n3 0 2 3\n"
        )
        m = ply.read_ply(str(f))
        assert m["vertices"].shape == (4, 3)
        assert m["faces"].shape == (2, 3)

    def test_binary(self, tmp_path):
        import struct

        f = tmp_path / "m.ply"
        header = (
            b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\nproperty list uchar int vertex_indices\n"
            b"end_header\n"
        )
        body = struct.pack("<9f", 0, 0, 0, 1, 0, 0, 0, 1, 0)
        body += struct.pack("<B3i", 3, 0, 1, 2)
        f.write_bytes(header + body)
        m = ply.read_ply(str(f))
        np.testing.assert_allclose(m["vertices"][1], [1, 0, 0])
        np.testing.assert_array_equal(m["faces"][0], [0, 1, 2])

    def test_quad_triangulation(self, tmp_path):
        f = tmp_path / "m.ply"
        f.write_text(
            "ply\nformat ascii 1.0\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 1\nproperty list uchar int vertex_indices\n"
            "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n"
        )
        m = ply.read_ply(str(f))
        assert m["faces"].shape == (2, 3)


class TestLoopSubdiv:
    def test_face_count_quadruples(self):
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
        f = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
        v2, f2 = loopsubdiv.subdivide(v, f, 1)
        assert len(f2) == 16
        assert len(v2) == 4 + 6  # verts + unique edges

    def test_smooths_toward_limit(self):
        # closed tetra shrinks toward centroid under Loop
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
        f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
        v2, f2 = loopsubdiv.subdivide(v, f, 2)
        c = v.mean(0)
        assert np.linalg.norm(v2 - c, axis=1).max() < np.linalg.norm(v - c, axis=1).max()

    def test_planar_boundary_stays_planar(self):
        v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float64)
        f = np.array([[0, 1, 2], [0, 2, 3]])
        v2, _ = loopsubdiv.subdivide(v, f, 2)
        np.testing.assert_allclose(v2[:, 2], 0, atol=1e-12)


class TestTransforms:
    def test_look_at_forward(self):
        m = xf.look_at((0, 0, -5), (0, 0, 5), (0, 1, 0))
        d = m[:3, :3] @ np.array([0, 0, 1.0])
        np.testing.assert_allclose(d, [0, 0, 1], atol=1e-6)

    def test_rotate_orthonormal(self):
        m = xf.rotate(37, (1, 2, 3))
        r = m[:3, :3]
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)

    def test_normal_transform(self):
        m = xf.scale((2, 1, 1))
        n = xf.apply_normals(m, np.array([[1.0, 0, 0]]))
        np.testing.assert_allclose(n, [[1, 0, 0]], atol=1e-6)
        n2 = xf.apply_normals(m, np.array([[1.0, 1, 0]]) / np.sqrt(2))
        # normals shear opposite to scale
        assert abs(n2[0, 0]) < abs(n2[0, 1])


class TestImageIO:
    def test_pfm_roundtrip(self, tmp_path):
        img = np.random.RandomState(0).rand(13, 7, 3).astype(np.float32)
        p = str(tmp_path / "t.pfm")
        image_mod.write_pfm(p, img)
        np.testing.assert_allclose(image_mod.read_pfm(p), img, rtol=1e-6)

    def test_exr_roundtrip(self, tmp_path):
        img = np.random.RandomState(1).rand(9, 11, 3).astype(np.float32) * 10
        p = str(tmp_path / "t.exr")
        image_mod.write_exr(p, img)
        np.testing.assert_allclose(image_mod.read_exr(p), img, rtol=1e-6)

    def test_png_writes(self, tmp_path):
        img = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)
        p = str(tmp_path / "t.png")
        image_mod.write_png(p, img)
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    def test_error_metrics(self):
        a = np.ones((4, 4, 3))
        b = np.zeros((4, 4, 3))
        assert image_mod.mse(a, b) == 1.0
        assert image_mod.mse(a, a) == 0.0


def test_animated_transform_interpolation():
    """AnimatedTransform (util/transform.h:444): T/R/S decomposition +
    slerp reproduces pure rotations exactly at keyframes and rotates rigidly
    (no shear) at midpoints, where direct matrix lerp would shrink."""
    import numpy as np
    from nn_bvh.geometry import animated, transform as xf

    m0 = np.eye(4, dtype=np.float32)
    m1 = np.asarray(xf.rotate(90.0, (0, 0, 1)), np.float32)
    at = animated.AnimatedTransform(m0, 0.0, m1, 1.0)
    assert at.actually_animated
    assert np.allclose(at.interpolate(0.0), m0, atol=1e-6)
    assert np.allclose(at.interpolate(1.0), m1, atol=1e-5)
    mid = at.interpolate(0.5)
    # rigid: rotating (1,0,0) stays unit length (matrix lerp gives 0.707)
    p = mid[:3, :3] @ np.array([1.0, 0, 0])
    assert abs(np.linalg.norm(p) - 1.0) < 1e-5
    # and lands at 45 degrees
    assert abs(np.degrees(np.arctan2(p[1], p[0])) - 45.0) < 1e-3

    # translation + rotation compose
    m2 = np.asarray(xf.translate((2, 0, 0)) @ xf.rotate(90.0, (0, 1, 0)),
                    np.float32)
    at2 = animated.AnimatedTransform(m0, 0.0, m2, 1.0)
    mid2 = at2.interpolate(0.5)
    assert np.allclose(mid2[:3, 3], [1.0, 0, 0], atol=1e-5)

    # motion bounds contain the swept box
    lo, hi = at2.motion_bounds(np.array([-0.1, -0.1, -0.1]),
                               np.array([0.1, 0.1, 0.1]))
    assert (lo <= -0.1).all() and hi[0] >= 2.1 - 1e-4
