"""Filters, PixelSensor, SpectralFilm, GBuffer, and camera-model tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from nn_bvh import accel
from nn_bvh.core import colorspace, spectrum
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import (camera as camera_mod, film as film_mod,
                                  filters, integrator)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["box", "triangle", "gaussian", "mitchell",
                                  "sinc"])
def test_filter_sample_weight_expectation(kind):
    """E[weight] over uniform u must equal the filter integral / support-
    uniform... with importance sampling, E[f/p] = integral of f."""
    cfg = filters.make_filter(kind)
    rs = np.random.RandomState(1)
    u = jnp.asarray(rs.rand(20000, 2), jnp.float32)
    off, w = filters.sample(cfg, u)
    rx, ry = cfg.radius
    assert np.all(np.abs(np.asarray(off)[:, 0]) <= rx + 1e-4)
    assert np.all(np.abs(np.asarray(off)[:, 1]) <= ry + 1e-4)
    got = float(np.mean(np.asarray(w)))
    if kind == "box":
        want = 1.0
    else:
        want = cfg.integral
    assert abs(got - want) / max(abs(want), 1e-9) < 0.05, (got, want)


def test_mitchell_negative_lobes():
    cfg = filters.make_filter("mitchell")
    f = np.asarray(filters.evaluate(cfg, jnp.asarray([[1.5, 0.0]])))
    assert f[0] < 0  # Mitchell has negative lobes


def test_gaussian_filter_render_preserves_mean():
    """A constant-radiance scene must develop to the same value under any
    filter (weights normalize out)."""
    b = scene_mod.SceneBuilder()
    b.add_quad((-1, -1, -50), (1, -1, -50), (1, 1, -50), (-1, 1, -50),
               b.add_material("diffuse", reflectance=(0, 0, 0)))
    b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=40.0, width=12,
        height=12)
    imgs = {}
    for kind in ["box", "gaussian"]:
        filt = filters.make_filter(kind)
        cfg = integrator.IntegratorConfig(max_depth=2, traversal="xla",
                                          filt=filt)
        imgs[kind] = np.mean(np.asarray(integrator.render(
            sc, dbvh, cam, spp=8, sampler="independent", cfg=cfg)))
    assert abs(imgs["gaussian"] / imgs["box"] - 1.0) < 0.02, imgs


# ---------------------------------------------------------------------------
# PixelSensor / color spaces
# ---------------------------------------------------------------------------

def test_rgb_spaces_roundtrip_white():
    for name, m in colorspace.RGB_TO_XYZ.items():
        white = m @ np.ones(3, np.float32)
        assert abs(white[1] - 1.0) < 1e-3, (name, white)  # Y of white = 1


def test_sensor_default_matches_develop():
    f = film_mod.make_film(2, 2)
    lam = jnp.full((4, 4), 550.0)
    pdf = jnp.full((4, 4), 1.0 / (spectrum.LAMBDA_MAX - spectrum.LAMBDA_MIN))
    L = jnp.ones((4, 4))
    f = film_mod.add_samples(f, jnp.arange(4), L, lam, pdf, sequential=True)
    a = np.asarray(film_mod.develop(f))
    s = film_mod.make_sensor()
    bb = np.asarray(film_mod.develop(f, sensor=s))
    assert np.allclose(a, bb, rtol=1e-2, atol=1e-3)
    # white-balance direction: the default sensor maps the render illuminant's
    # whitepoint to neutral; a 3000K-balanced sensor maps the (bluer) standard
    # illuminant to a blue-shifted RGB
    wp = spectrum.illuminant_whitepoint_xyz()
    neutral = np.asarray(film_mod.make_sensor().xyz_to_rgb) @ wp
    assert np.allclose(neutral / neutral.max(), 1.0, atol=0.02), neutral
    hot = np.asarray(
        film_mod.make_sensor(white_balance_temp=3000.0).xyz_to_rgb) @ wp
    assert hot[2] / hot[0] > 1.5, hot


def test_spectral_film_buckets():
    sf = film_mod.make_spectral_film(1, 1, n_buckets=8)
    lam = jnp.asarray([[400.0, 500.0, 600.0, 700.0]])
    pdf = jnp.ones((1, 4))
    L = jnp.asarray([[1.0, 2.0, 3.0, 4.0]])
    sf = film_mod.add_samples_spectral(sf, jnp.asarray([0]), L, lam, pdf,
                                       sequential=True)
    out = np.asarray(film_mod.develop_spectral(sf))[0, 0]
    # each wavelength fell into a distinct bucket with its value
    assert sorted(out[out > 0].tolist()) == [1.0, 2.0, 3.0, 4.0]


# ---------------------------------------------------------------------------
# GBuffer
# ---------------------------------------------------------------------------

def test_gbuffer_aovs():
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.8, 0.2, 0.1))
    b.add_quad((-5, -5, 2), (5, -5, 2), (5, 5, 2), (-5, 5, 2), m)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=30.0, width=8,
        height=8)
    g = integrator.render_gbuffer(sc, dbvh, cam)
    assert np.all(np.asarray(g["mask"]) == 1.0)
    assert np.allclose(np.asarray(g["p"])[..., 2], 2.0, atol=1e-3)
    assert np.allclose(np.abs(np.asarray(g["ns"])[..., 2]), 1.0, atol=1e-3)
    alb = np.asarray(g["albedo"]).reshape(-1, 3).mean(0)
    assert alb[0] > alb[1] > alb[2]  # red-ish albedo
    assert np.all(np.asarray(g["depth"]) >= 2.0 - 1e-3)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def test_spherical_camera_covers_sphere():
    cam = camera_mod.make_spherical(np.eye(4), 16, 16, mapping="equalarea")
    R = 16 * 16
    pi = jnp.arange(R, dtype=jnp.int32)
    u = jnp.full((R, 2), 0.5)
    o, d = camera_mod.generate_rays(cam, pi, u, u)
    d = np.asarray(d)
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # equal-area: mean direction ~ 0 (uniform sphere coverage)
    assert np.linalg.norm(d.mean(0)) < 0.05
    cam2 = camera_mod.make_spherical(np.eye(4), 16, 16,
                                     mapping="equirectangular")
    _, d2 = camera_mod.generate_rays(cam2, pi, u, u)
    assert np.allclose(np.linalg.norm(np.asarray(d2), axis=-1), 1.0, atol=1e-4)


def test_realistic_camera_rays_form_image():
    """Lens stack traces: central film point yields near-axial rays; most
    rays exit the lens (not vignetted) and converge forward (+z)."""
    cam = camera_mod.make_realistic(np.eye(4), 9, 9, focus_distance=2000.0)
    R = 81
    pi = jnp.arange(R, dtype=jnp.int32)
    u = jnp.full((R, 2), 0.5)
    rs = np.random.RandomState(0)
    ulens = jnp.asarray(rs.rand(R, 2) * 0.8 + 0.1, jnp.float32)
    o, d = camera_mod.generate_rays(cam, pi, u, ulens)
    d = np.asarray(d)
    ok = np.asarray(o)[:, 2] > -1e6
    assert ok.mean() > 0.5, ok.mean()  # most rays make it through
    assert np.all(d[ok][:, 2] > 0.2)   # all exit forward
    # center pixel: ray direction near the axis
    c = 4 * 9 + 4
    if ok[c]:
        assert abs(d[c, 0]) < 0.3 and abs(d[c, 1]) < 0.3


def test_camera_motion_blur_smears():
    """Camera motion blur (AnimatedTransform keys + per-ray shutter time):
    a moving camera smears a high-contrast edge that a static camera keeps
    sharp (cameras.h shutteropen/close semantics)."""
    import numpy as np
    import jax.numpy as jnp
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf
    from nn_bvh.wavefront import camera as camera_mod, integrator

    b = scene_mod.SceneBuilder()
    white = b.add_material("diffuse", reflectance=(0.9, 0.9, 0.9))
    # a thin bright quad against black space
    b.add_quad((-0.15, -2, 0), (0.15, -2, 0), (0.15, 2, 0), (-0.15, 2, 0),
               white)
    b.add_uniform_infinite_light((1, 1, 1), scale=0.02)
    lid = b.add_point_light((0, 0, -3), scale=40.0)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    m0 = xf.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0))
    m1 = xf.look_at((1.2, 0, -4), (1.2, 0, 0), (0, 1, 0))
    cam = camera_mod.make_perspective(m0, fov=35.0, width=48, height=8)
    cfg = integrator.IntegratorConfig(max_depth=2, traversal="xla")
    sharp = np.asarray(integrator.render(sc, dbvh, cam, spp=8,
                                         sampler="independent", cfg=cfg))
    cam_mb = camera_mod.with_motion(cam, m1)
    blurred = np.asarray(integrator.render(sc, dbvh, cam_mb, spp=16,
                                           sampler="independent", cfg=cfg))
    row_s = sharp[4].mean(-1)
    row_b = blurred[4].mean(-1)
    # static: narrow bright band; animated: wider, dimmer band
    thr = 0.4 * row_s.max()
    assert (row_b > 0.4 * row_b.max()).sum() > 1.8 * (row_s > thr).sum(), (
        (row_s > thr).sum(), (row_b > 0.4 * row_b.max()).sum())
    assert row_b.max() < 0.8 * row_s.max()
