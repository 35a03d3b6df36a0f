"""LightPath integrator + FunctionIntegrator tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator, lightpath


def _box_scene():
    """Diffuse box interior with a ceiling area light."""
    b = scene_mod.SceneBuilder()
    grey = b.add_material("diffuse", reflectance=(0.6, 0.55, 0.5))
    s = 3.0
    # floor / back / ceiling (inward normals)
    b.add_quad((-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s), grey)
    b.add_quad((-s, 2 * s, s), (s, 2 * s, s), (s, 0, s), (-s, 0, s), grey)
    b.add_quad((-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s), (-s, 2 * s, s),
               grey)
    b.add_quad((-1, 5.9, -1), (1, 5.9, -1), (1, 5.9, 1), (-1, 5.9, 1), grey,
               emission_rgb=(1, 1, 1), emission_scale=14.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 3.0, -2.8), (0, 1.2, 0.8), (0, 1, 0)), fov=55.0,
        width=20, height=20)
    return sc, dbvh, cam


@pytest.mark.slow
def test_lightpath_matches_path():
    """Light tracing and path tracing estimate the same image (mean within
    statistical tolerance) — the strongest check of the camera importance
    We/SampleWi radiometry."""
    sc, dbvh, cam = _box_scene()
    cfg = integrator.IntegratorConfig(max_depth=4, traversal="xla")
    fwd = integrator.render(sc, dbvh, cam, spp=64, sampler="independent",
                            seed=1, cfg=cfg)
    # light tracing never sees emitters directly through the camera; compare
    # against the forward render with emitted-at-camera contribution removed
    # by keeping the light out of view (it is: camera looks away from ceiling)
    bwd = lightpath.render_lightpath(sc, dbvh, cam, spp=96, seed=2,
                                     cfg=integrator.IntegratorConfig(
                                         max_depth=4, traversal="xla"),
                                     paths_per_wave=cam.width * cam.height * 4)
    a = float(np.mean(np.asarray(fwd)))
    c = float(np.mean(np.asarray(bwd)))
    assert c > 0
    assert abs(c - a) / a < 0.12, (a, c)


def test_function_integrator_converges():
    img = lightpath.render_function(
        lambda u, v: jnp.sin(np.pi * u) * v, width=32, height=32, spp=16,
        sampler="sobol")
    got = float(np.mean(np.asarray(img)))
    want = (2.0 / np.pi) * 0.5  # int sin(pi u) du * int v dv
    assert abs(got - want) < 5e-3, (got, want)
    # independent sampling also converges, but with more image-mean error
    # headroom (the reference uses FunctionIntegrator exactly for such
    # sampler comparisons)
    img2 = lightpath.render_function(
        lambda u, v: jnp.sin(np.pi * u) * v, width=32, height=32, spp=16,
        sampler="independent")
    assert abs(float(np.mean(np.asarray(img2))) - want) < 2e-2
