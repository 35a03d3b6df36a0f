"""Analytic quadric tests (geometry/quadrics.py vs shapes.h:107,404,574).

Render-level parity vs the reference binary is checked by
tools/probe_material.py --shape (sphere -0.03%, disk -0.04%, cylinder
+0.06% scene mean); these tests lock the intersection math and the
scene/dispatch integration without the binary."""

import numpy as np
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.accel import dispatch
from nn_bvh.geometry import quadrics, scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator


def _tables(recs):
    qt = jnp.asarray(np.array([r[0] for r in recs], np.int32))
    qp = jnp.asarray(np.stack([r[1] for r in recs]))
    return qt, qp


def test_sphere_intersection_exact():
    qt, qp = _tables([quadrics.make_record("sphere", (0, 0, 5), 1.0)])
    o = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, 10.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    tm = jnp.full((3,), 1e30)
    t, idx, u, v = quadrics.intersect(qt, qp, o, d, tm)
    assert np.allclose(np.asarray(t)[[0, 2]], [4.0, 4.0], atol=1e-5)
    assert int(idx[1]) == -1  # ray misses
    # uv: hit at -z pole side from origin -> theta = pi -> v = 1
    assert 0.95 < float(v[0]) <= 1.0


def test_sphere_inside_hit_and_tmax():
    qt, qp = _tables([quadrics.make_record("sphere", (0, 0, 0), 2.0)])
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    t, idx, _, _ = quadrics.intersect(qt, qp, o, d, jnp.full((1,), 1e30))
    assert np.allclose(float(t[0]), 2.0, atol=1e-5)  # exits through shell
    # t_max shorter than the hit -> miss
    t2, idx2, _, _ = quadrics.intersect(qt, qp, o, d, jnp.full((1,), 1.5))
    assert int(idx2[0]) == -1


def test_disk_annulus():
    qt, qp = _tables([quadrics.make_record("disk", (0, 0, 2), 1.0,
                                           inner_radius=0.5)])
    o = jnp.asarray([[0.0, 0.0, 0.0], [0.7, 0.0, 0.0], [0.2, 0.0, 0.0]])
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (3, 3))
    t, idx, _, _ = quadrics.intersect(qt, qp, o, d, jnp.full((3,), 1e30))
    assert int(idx[0]) == -1       # center hole
    assert int(idx[1]) == 0        # annulus
    assert int(idx[2]) == -1       # inside inner radius
    assert np.allclose(float(t[1]), 2.0, atol=1e-5)


def test_cylinder_z_clip():
    qt, qp = _tables([quadrics.make_record("cylinder", (0, 0, 0), 1.0,
                                           zmin=-1.0, zmax=1.0)])
    o = jnp.asarray([[-5.0, 0.0, 0.0], [-5.0, 0.0, 2.0]])
    d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (2, 3))
    t, idx, _, _ = quadrics.intersect(qt, qp, o, d, jnp.full((2,), 1e30))
    assert int(idx[0]) == 0 and np.allclose(float(t[0]), 4.0, atol=1e-5)
    assert int(idx[1]) == -1  # above zmax


def test_closest_picks_nearest_of_many():
    qt, qp = _tables([quadrics.make_record("sphere", (0, 0, 5), 1.0),
                      quadrics.make_record("sphere", (0, 0, 9), 1.0)])
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, idx, _, _ = quadrics.intersect(qt, qp, o, d, jnp.full((1,), 1e30))
    assert int(idx[0]) == 0 and np.allclose(float(t[0]), 4.0, atol=1e-5)


def test_render_analytic_sphere_no_sag():
    """End-to-end: analytic emissive-free sphere over a floor; the sphere
    contact shadow must be present (no inscribed-mesh light leak) and the
    silhouette exact: compare the hit mask radius against the projection."""
    b = scene_mod.SceneBuilder()
    white = b.add_material("diffuse", reflectance=(0.8, 0.8, 0.8))
    b.add_quadric("sphere", (0, 1.0, 0), 1.0, white)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    b.add_quad((-6, 0, -6), (6, 0, -6), (6, 0, 6), (-6, 0, 6), floor)
    b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
    sc = b.build()
    assert sc.n_quadrics == 1
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.0, -5), (0, 1.0, 0), (0, 1, 0)), fov=30.0,
        width=64, height=64)
    cfg = integrator.IntegratorConfig(max_depth=3, traversal="xla")
    img = np.asarray(integrator.render(sc, dbvh, cam, spp=8,
                                       sampler="independent", cfg=cfg))
    assert np.isfinite(img).all() and img.mean() > 0.05
    # exact silhouette: rays through the center plane at angle theta hit the
    # sphere iff sin(theta) <= r/d (analytic, no tessellation chords)
    isect = dispatch.make_intersectors(sc, dbvh, traversal="xla")
    thetas = np.linspace(-0.35, 0.35, 201)
    d_rays = np.stack([np.sin(thetas), np.zeros_like(thetas),
                       np.cos(thetas)], -1).astype(np.float32)
    o_rays = np.broadcast_to(np.array([0, 1.0, -5], np.float32), d_rays.shape)
    hit = isect.closest(jnp.asarray(o_rays), jnp.asarray(d_rays),
                        jnp.full((201,), 6.0))
    quad_base = sc.tri_p.shape[0]
    hit_sphere = np.asarray(hit.prim) >= quad_base
    lim = np.arcsin(1.0 / 5.0)
    expect = np.abs(thetas) <= lim
    # allow one transition sample of slack at each edge
    assert (hit_sphere != expect).sum() <= 2, (hit_sphere.sum(), expect.sum())


def test_quadric_dispatch_any_hit_occludes():
    """Shadow rays see analytic quadrics (dispatch merge): a sphere between
    light sample and shading point occludes."""
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse")
    b.add_quadric("sphere", (0, 2, 0), 0.5, m)
    b.add_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3), m)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    isect = dispatch.make_intersectors(sc, dbvh, traversal="xla")
    o = jnp.asarray([[0.0, 0.01, 0.0], [2.5, 0.01, 0.0]])
    d = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (2, 3))
    occ = isect.any_hit(o, d, jnp.full((2,), 10.0))
    assert bool(occ[0]) and not bool(occ[1])
    hit = isect.closest(o, d, jnp.full((2,), 1e30))
    assert abs(float(hit.t[0]) - 1.49) < 1e-5
    assert int(hit.prim[0]) >= sc.tri_p.shape[0]  # quadric id space


def test_bilinear_patch_reshetov():
    """Non-planar (twisted) bilinear patch: the Reshetov intersection finds
    the curved surface where a 2-triangle split would be wrong
    (shapes.h:1279)."""
    # twisted patch: p11 lifted out of the p00/p10/p01 plane
    p00, p10 = np.array([0, 0, 0.0]), np.array([1, 0, 0.0])
    p01, p11 = np.array([0, 1, 0.0]), np.array([1, 1, 1.0])
    kind, rec = quadrics.make_bilinear_record(p00, p10, p01, p11)
    qtypes = jnp.asarray([kind], jnp.int32)
    qparams = jnp.asarray(rec[None])

    # ray straight down at (u, v) = (0.5, 0.5): P = avg corners = (.5,.5,.25)
    o = jnp.asarray([[0.5, 0.5, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    t, idx, u, v = quadrics.intersect(qtypes, qparams, o, d,
                                      jnp.full((1,), 1e30))
    assert int(idx[0]) == 0
    assert abs(float(t[0]) - 4.75) < 1e-4, float(t[0])
    assert abs(float(u[0]) - 0.5) < 1e-4 and abs(float(v[0]) - 0.5) < 1e-4

    # parametric sweep: hits must satisfy P(u,v) = o + t d to high precision
    rs = np.random.RandomState(0)
    n = 256
    uu, vv = rs.rand(n), rs.rand(n)
    targets = ((1 - uu)[:, None] * (1 - vv)[:, None] * p00
               + uu[:, None] * (1 - vv)[:, None] * p10
               + (1 - uu)[:, None] * vv[:, None] * p01
               + uu[:, None] * vv[:, None] * p11)
    o2 = jnp.asarray(targets + [0, 0, 3.0], jnp.float32)
    d2 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), (n, 3))
    t2, idx2, u2_, v2_ = quadrics.intersect(qtypes, qparams, o2, d2,
                                            jnp.full((n,), 1e30))
    hit = np.asarray(idx2) == 0
    assert hit.mean() > 0.99, hit.mean()
    assert np.allclose(np.asarray(u2_)[hit], uu[hit], atol=2e-3)
    assert np.allclose(np.asarray(v2_)[hit], vv[hit], atol=2e-3)

    # normal at center: dPdu x dPdv oriented toward the ray origin
    p, nrm = quadrics.shading(qtypes, qparams, jnp.zeros((1,), jnp.int32),
                              o, d, t, u=u, v=v)
    nrm = np.asarray(nrm)[0]
    dpdu = (p10 - p00) + 0.5 * (p11 - p10 - p01 + p00)
    dpdv = (p01 - p00) + 0.5 * (p11 - p10 - p01 + p00)
    want = np.cross(dpdu, dpdv)
    want = want / np.linalg.norm(want)
    if np.dot(want, [0, 0, -1]) > 0:
        want = -want
    assert np.allclose(nrm, want, atol=1e-4), (nrm, want)


def test_bilinear_patch_planar_matches_quad():
    """A planar patch behaves exactly like its two triangles."""
    kind, rec = quadrics.make_bilinear_record(
        [0, 0, 2.0], [1, 0, 2.0], [0, 1, 2.0], [1, 1, 2.0])
    qtypes = jnp.asarray([kind], jnp.int32)
    qparams = jnp.asarray(rec[None])
    o = jnp.asarray([[0.3, 0.7, 0.0], [1.5, 0.5, 0.0]])
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3))
    t, idx, u, v = quadrics.intersect(qtypes, qparams, o, d,
                                      jnp.full((2,), 1e30))
    assert int(idx[0]) == 0 and abs(float(t[0]) - 2.0) < 1e-5
    assert abs(float(u[0]) - 0.3) < 1e-4 and abs(float(v[0]) - 0.7) < 1e-4
    assert int(idx[1]) == -1  # outside the patch
