"""SPPM integrator tests (SPPMIntegrator, cpu/integrators.h:436).

Same idiom as integrators_test.cpp: analytic scenes, cross-integrator
agreement with Path within the reference's +-0.025 band."""

import numpy as np
import pytest
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator, sppm

RES = 16
TOL = 0.025


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


def test_sppm_direct_matches_path():
    """Depth-1 transport is entirely the camera-pass direct term — it must
    match the Path integrator's depth-1 render to MC noise."""
    sc, dbvh, cam = quad_light_scene()
    cfg = integrator.IntegratorConfig(max_depth=1, mis=False, rr_depth=99)
    img_p = integrator.render(sc, dbvh, cam, spp=32, seed=2, cfg=cfg)
    img_s = sppm.render_sppm(sc, dbvh, cam, n_iterations=8,
                             photons_per_iter=64, seed=3, cfg=cfg)
    m_p, m_s = float(jnp.mean(img_p)), float(jnp.mean(img_s))
    assert abs(m_p - m_s) < TOL, (m_p, m_s)


@pytest.mark.slow
def test_sppm_indirect_matches_path():
    """Depth-3 diffuse interreflection: photon density estimation must agree
    with the unbiased path estimate within the reference's band (radius bias
    shrinks with iterations; generous initial radius + tolerance 2x)."""
    sc, dbvh, cam = quad_light_scene()
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=99)
    img_p = integrator.render(sc, dbvh, cam, spp=48, seed=2, cfg=cfg)
    img_s = sppm.render_sppm(sc, dbvh, cam, n_iterations=12,
                             photons_per_iter=2048, seed=5, cfg=cfg,
                             k_cap=32)
    m_p, m_s = float(jnp.mean(img_p)), float(jnp.mean(img_s))
    assert abs(m_p - m_s) < 2 * TOL, (m_p, m_s)


@pytest.mark.slow
def test_sppm_radius_shrinks_and_stats():
    """Per-pixel radii must shrink monotonically where photons land, and the
    dropped-photon counter reports cap overflow instead of hiding it."""
    sc, dbvh, cam = quad_light_scene()
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, rr_depth=99)
    from nn_bvh.scatter import lightsamplers
    ls = lightsamplers.build(sc, cfg.light_sampler)
    st0 = sppm.make_state(RES * RES, 0.5)
    # explicit photon depth: this open scene needs two bounces for photons to
    # land back on the floor (default D_ph now matches cfg.max_depth exactly,
    # reference depth semantics)
    st1 = sppm.sppm_iteration(sc, dbvh, cam, cfg, st0, jnp.int32(0), 512, ls,
                              max_photon_depth=4)
    st2 = sppm.sppm_iteration(sc, dbvh, cam, cfg, st1, jnp.int32(1), 512, ls,
                              max_photon_depth=4)
    r1, r2 = np.asarray(st1.r2), np.asarray(st2.r2)
    assert np.all(r2 <= r1 + 1e-7)
    assert np.any(r2 < 0.25 - 1e-6), "no pixel ever received a photon"
    assert np.all(np.asarray(st2.n) >= np.asarray(st1.n))
    assert int(st2.dropped) >= 0
