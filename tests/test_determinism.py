"""Determinism gates (SURVEY §5.2): same seed => bit-identical image.

The reference's equivalent discipline is CHECK macros + --debugstart crash
context; on an accelerator the analog risk is nondeterministic reduction order. Film
accumulation here is a sequential per-wave vector add / index-ordered
scatter-add, so renders must be EXACTLY reproducible — this is also what
makes the multi-host film-band reduction exact (dist/sharding.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.wavefront import camera as camera_mod, integrator


def _scene():
    b = scene_mod.SceneBuilder()
    red = b.add_material("diffuse", reflectance=(0.7, 0.2, 0.2))
    coat = b.add_material("coateddiffuse", reflectance=(0.3, 0.5, 0.7),
                          coat_roughness=0.1)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), red)
    b.add_sphere((0, 1, 0), 0.8, coat, n_theta=8, n_phi=16)
    b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 2.5, -4), (0, 0.6, 0), (0, 1, 0)), fov=40.0,
        width=16, height=16)
    return sc, dbvh, cam


def test_same_seed_bit_identical():
    sc, dbvh, cam = _scene()
    cfg = integrator.IntegratorConfig(max_depth=3, traversal="xla")
    img1 = np.asarray(integrator.render(sc, dbvh, cam, spp=2, seed=7,
                                        sampler="sobol", cfg=cfg))
    img2 = np.asarray(integrator.render(sc, dbvh, cam, spp=2, seed=7,
                                        sampler="sobol", cfg=cfg))
    assert np.array_equal(img1, img2), np.abs(img1 - img2).max()
    # and a different seed must actually change the image
    img3 = np.asarray(integrator.render(sc, dbvh, cam, spp=2, seed=8,
                                        sampler="sobol", cfg=cfg))
    assert not np.array_equal(img1, img3)


@pytest.mark.slow
def test_sharded_render_matches_single_device():
    """8-virtual-device tile-sharded render == single-device render exactly
    (order-independent film accumulation; dist/sharding.py)."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")
    from nn_bvh.dist import sharding as dist_sharding

    sc, dbvh, cam = _scene()
    cfg = integrator.IntegratorConfig(max_depth=3, traversal="xla")
    single = np.asarray(integrator.render(sc, dbvh, cam, spp=2, seed=3,
                                          sampler="sobol", cfg=cfg))
    mesh = dist_sharding.make_mesh(8)
    sharded = np.asarray(dist_sharding.render_sharded(
        sc, dbvh, cam, mesh, spp=2, seed=3, sampler="sobol", cfg=cfg))
    # sharded and single-device are DIFFERENT XLA programs; fusion order can
    # differ by an ulp — the determinism guarantee is per-program. Cross-
    # program agreement is gated at float tolerance...
    assert np.allclose(single, sharded, rtol=1e-5, atol=1e-6), \
        np.abs(single - sharded).max()
    # ...and the sharded program itself must be bit-reproducible.
    sharded2 = np.asarray(dist_sharding.render_sharded(
        sc, dbvh, cam, mesh, spp=2, seed=3, sampler="sobol", cfg=cfg))
    assert np.array_equal(sharded, sharded2)
