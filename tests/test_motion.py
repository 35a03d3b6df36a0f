"""Object motion blur: parser directives -> keyframed vertex tables ->
per-wave shutter-time lerp (AnimatedPrimitive analog, cpu/primitive.h:33 /
util/transform.h:444 AnimatedTransform; parser.h ActiveTransform /
TransformTimes directives).

Design under test: each 1-spp wave renders at ONE stratified
shutter time; geometry lerps between shutter keyframes per wave (tables and
vertex records are linear in positions), and the BVH is built once over the
union of both keyframes' bounds, so the traversal kernels never see a
time axis.
"""

import os
import tempfile

import numpy as np
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.core import rng, samplers
from nn_bvh.geometry import scene as scene_mod, transform as xf, \
    pbrt_parser
from nn_bvh.wavefront import integrator, camera as camera_mod, \
    film as film_mod


def _mk_scene(quad_offset: float, animated_to: float | None = None):
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.8, 0.2, 0.2))
    floor = b.add_material("diffuse", reflectance=(0.4, 0.4, 0.4))
    v = np.array([[-0.4, 1.0, 0], [0.4, 1.0, 0], [0.4, 1.8, 0],
                  [-0.4, 1.8, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    t0 = xf.translate([quad_offset, 0, 0])
    te = (xf.translate([animated_to, 0, 0])
          if animated_to is not None else None)
    b.add_mesh(v, f, m, transform=t0, transform_end=te)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), floor)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), floor,
               emission_rgb=(1, 1, 1), emission_scale=12.0, two_sided=True)
    sc = b.build()
    return accel.build_scene_bvh(sc)[:2]


_CAM = camera_mod.make_perspective(
    xf.look_at((0, 1.4, -3.5), (0, 1.4, 0), (0, 1, 0)), fov=45.0,
    width=32, height=32)


def test_animated_wave_equals_static_at_wave_time():
    """spp=1: the animated wave's single shutter time t0 must reproduce the
    static scene built at exactly lerp(t0) — the lerp path is exact."""
    spp = 1
    # the wave's deterministic time jitter (integrator.make_wave_fn)
    u = float(rng.hash_float(jnp.asarray([0], jnp.int32),
                             jnp.asarray([0], jnp.int32),
                             jnp.uint32(0x51))[0])
    t0 = (0 + u) / spp

    sc_a, dbvh_a = _mk_scene(-0.8, animated_to=0.8)
    assert sc_a.tri_p_end is not None
    img_anim = integrator.render(
        sc_a, dbvh_a, _CAM, spp=spp,
        cfg=integrator.IntegratorConfig(max_depth=2))

    off_t = -0.8 + t0 * 1.6
    sc_s, dbvh_s = _mk_scene(off_t)
    # same leaf ordering is not guaranteed between the two builds; compare
    # IMAGES (the BVHs differ but hits must agree)
    img_stat = integrator.render(
        sc_s, dbvh_s, _CAM, spp=spp,
        cfg=integrator.IntegratorConfig(max_depth=2))
    np.testing.assert_allclose(np.asarray(img_anim), np.asarray(img_stat),
                               atol=2e-3, rtol=1e-3)


def test_motion_smears_the_band():
    """Moving quad at high spp: union coverage widens, peak dims (the same
    gate idiom as the r4 camera-blur test)."""
    sc_a, dbvh_a = _mk_scene(-0.6, animated_to=0.6)
    sc_s, dbvh_s = _mk_scene(0.0)
    cfg = integrator.IntegratorConfig(max_depth=2)
    img_a = np.asarray(integrator.render(sc_a, dbvh_a, _CAM, spp=8, cfg=cfg))
    img_s = np.asarray(integrator.render(sc_s, dbvh_s, _CAM, spp=8, cfg=cfg))
    red_a = (img_a[..., 0] > 1.5 * img_a[..., 2] + 0.02)
    red_s = (img_s[..., 0] > 1.5 * img_s[..., 2] + 0.02)
    assert red_a.sum() > 1.5 * red_s.sum()  # smeared across more pixels


def test_parser_active_transform():
    src = """
LookAt 0 1 -4  0 1 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
AttributeBegin
ActiveTransform EndTime
Translate 1.2 0 0
ActiveTransform All
Shape "trianglemesh" "point3 P" [-0.5 0.5 0  0.5 0.5 0  0 1.5 0]
    "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
Translate 0 0 1
Shape "trianglemesh" "point3 P" [-0.5 0.5 0  0.5 0.5 0  0 1.5 0]
    "integer indices" [0 1 2]
AttributeEnd
"""
    with tempfile.NamedTemporaryFile("w", suffix=".pbrt", delete=False) as f:
        f.write(src)
        path = f.name
    try:
        sc, dbvh, cam, res = pbrt_parser.load_scene(path)
    finally:
        os.unlink(path)
    assert sc.tri_p_end is not None
    n = sc.n_tris
    tp = np.asarray(sc.tri_p)[:n]
    te = np.asarray(sc.tri_p_end)[:n]
    moved = np.abs(te - tp).max(axis=(1, 2))
    # exactly one of the two triangles is animated, displaced by 1.2 in x
    assert (moved > 1.0).sum() == 1 and (moved < 1e-6).sum() == 1
    d = (te - tp)[moved.argmax()]
    np.testing.assert_allclose(d[:, 0], 1.2, atol=1e-5)
    np.testing.assert_allclose(d[:, 1:], 0.0, atol=1e-5)
