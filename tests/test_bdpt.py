"""BDPT integrator tests (BDPTIntegrator, cpu/integrators.h:345).

Same idiom as integrators_test.cpp: analytic scenes, cross-integrator
agreement with Path within the reference's +-0.025 band. Depths kept small:
the strategy fan-out is O(depth^2) jitted stages and CPU compile time grows
with it."""

import numpy as np
import pytest
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator, bdpt

RES = 16
TOL = 0.025


def furnace_scene(albedo=0.5, le=0.5):
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(albedo, albedo, albedo))
    b.add_sphere((0, 0, 0), 10.0, m, n_theta=24, n_phi=48,
                 emission_rgb=(1, 1, 1), emission_scale=le, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0)), fov=90.0,
        width=RES, height=RES)
    return sc, dbvh, cam


def quad_light_scene():
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.7, 0.7, 0.7))
    b.add_quad((-5, -1, -5), (5, -1, -5), (5, -1, 5), (-5, -1, 5), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.0, -4), (0, 0, 0), (0, 1, 0)), fov=60.0,
        width=RES, height=RES)
    return sc, dbvh, cam


@pytest.mark.slow
def test_bdpt_matches_path_arealight():
    """Area-light scene: BDPT and Path converge to the same mean — checks
    that the per-strategy MIS weights sum to 1 over each path length."""
    sc, dbvh, cam = quad_light_scene()
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=99)
    img_p = integrator.render(sc, dbvh, cam, spp=24, seed=2, cfg=cfg)
    img_b = bdpt.render_bdpt(sc, dbvh, cam, spp=12, seed=5, cfg=cfg)
    m_p, m_b = float(jnp.mean(img_p)), float(jnp.mean(img_b))
    assert abs(m_p - m_b) < TOL, (m_p, m_b)


def test_bdpt_furnace_matches_path():
    """Emissive furnace at equal truncation depth: BDPT == Path (exercises
    s=0 emissive hits and specular-free connection weighting)."""
    sc, dbvh, cam = furnace_scene(albedo=0.5, le=0.5)
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, rr_depth=99,
                                      light_sampler="power")
    img_p = integrator.render(sc, dbvh, cam, spp=12, seed=1, cfg=cfg)
    img_b = bdpt.render_bdpt(sc, dbvh, cam, spp=8, seed=4, cfg=cfg)
    m_p, m_b = float(jnp.mean(img_p)), float(jnp.mean(img_b))
    assert abs(m_p - m_b) < 2 * TOL, (m_p, m_b)
