"""Phase-ladder wavefront compaction (volpath.make_phased_wave).

The compacted driver re-tiles the wave to smaller static shapes as lanes
die (the analog of the reference's shrinking WorkQueue sizes,
wavefront/workqueue.h:42). These tests pin its exactness: the phased film
must match the plain single-jit trace bit-for-bit-ish (only summation
order inside film scatter differs; pixels are unique per wave so even that
is exact).

Marked slow: each volpath variant is a multi-minute XLA compile on a
small CPU box.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import integrator, volpath, camera as camera_mod, \
    film as film_mod
from nn_bvh.core import samplers


pytestmark = pytest.mark.slow


def _scene_with_medium():
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.3, 0.3, 0.3))
    b.add_sphere((0, 1, 0), 0.8, m, n_theta=10, n_phi=20, med_inside=fog)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=10.0, two_sided=True)
    sc = b.build()
    return accel.build_scene_bvh(sc)[:2]


def test_phased_wave_matches_plain_volpath():
    sc, dbvh = _scene_with_medium()
    cam = camera_mod.make_perspective(
        xf.look_at((0, 2, -4), (0, 1, 0), (0, 1, 0)), fov=50.0,
        width=24, height=24)
    cfg = integrator.IntegratorConfig(max_depth=6, kind="volpath", rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=2)

    img_plain = integrator.render(sc, dbvh, cam, spp=2,
                                  cfg=cfg._replace(compact=False))

    wave = volpath.make_phased_wave(sc, dbvh, cam, scfg, cfg, phase_len=2)
    film = film_mod.make_film(cam.height, cam.width)
    for s in range(2):
        film = wave(film, jnp.int32(s))
    img_ph = film_mod.develop(film)
    np.testing.assert_allclose(np.asarray(img_ph), np.asarray(img_plain),
                               atol=1e-5, rtol=1e-5)
