"""MLT integrator tests (MLTIntegrator, cpu/integrators.h:384): the PSS
Metropolis chain must converge to the same image as the Path integrator."""

import numpy as np
import pytest
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator, mlt

RES = 16


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
def test_mlt_matches_path():
    sc, dbvh, cam = quad_light_scene()
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=99)
    img_p = integrator.render(sc, dbvh, cam, spp=24, seed=2, cfg=cfg)
    img_m = mlt.render_mlt(sc, dbvh, cam, spp=96, seed=9, cfg=cfg,
                           n_chains=1024)
    m_p, m_m = float(jnp.mean(img_p)), float(jnp.mean(img_m))
    # MLT brightness is set by the bootstrap b estimate: allow a wider band
    # than the +-0.025 reference gate, relative to the scene mean
    assert abs(m_p - m_m) < max(0.03, 0.15 * m_p), (m_p, m_m)
    # bright region (floor under the light) must appear in the same place
    a, b_ = np.asarray(img_p).mean(-1), np.asarray(img_m).mean(-1)
    assert np.corrcoef(a.ravel(), b_.ravel())[0, 1] > 0.8
