"""Joint renderer+treeNet program (learn/joint.py): gradients must flow to
BOTH parameter sets in one step (VERDICT r2 item 4 — the capability the
reference fork never built; its coupling was offline binary artifacts,
nss_model_test.py:37)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nn_bvh import accel
from nn_bvh.core import samplers
from nn_bvh.geometry import scene as scene_mod, transform as xf
from nn_bvh.learn import joint, treenet
from nn_bvh.scatter import lightsamplers
from nn_bvh.wavefront import camera as camera_mod, integrator


@pytest.fixture(scope="module")
def tiny():
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_sphere((0, 0.6, 0), 0.6, m, n_theta=6, n_phi=12)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=6.0, two_sided=True)
    sc = b.build()
    sc, dbvh, _ = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0)), fov=45.0,
        width=8, height=8)
    return sc, dbvh, cam


@pytest.mark.slow
def test_joint_step_grads_both_branches(tiny):
    sc, dbvh, cam = tiny
    tree_cfg = treenet.TreeNetConfig(levels=2, capacity=8, pc_size=32)
    params = treenet.init_params(tree_cfg, jax.random.PRNGKey(0))

    # render through the PREDICTED tree (host rebuild, the outer coupling)
    sc2, dbvh2, _ = joint.rebuild_scene_with_predicted_tree(
        sc, params, tree_cfg, pc_size=tree_cfg.pc_size)
    lst = lightsamplers.build(sc2, "power")

    sampler_cfg = samplers.make_sampler("independent", seed=0, spp=2)
    cfg = integrator.IntegratorConfig(max_depth=1, mis=True, traversal="xla")
    state = joint.JointState(tree_params=params,
                             mat_coeffs=jnp.asarray(sc2.mat_coeffs))
    clouds = jnp.asarray(joint.scene_cloud(sc2, tree_cfg.pc_size, batch=2))
    step = jax.jit(joint.make_joint_step(tree_cfg, cam, sampler_cfg, cfg))

    R = cam.width * cam.height
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, sc2),
                              jax.tree.map(jnp.asarray, dbvh2),
                              jax.tree.map(jnp.asarray, lst), clouds,
                              jnp.arange(R, dtype=jnp.int32), jnp.int32(0))
    m = {k: float(v) for k, v in metrics.items()}
    assert np.isfinite(m["loss"]), m
    assert np.isfinite(m["image_loss"]) and m["image_loss"] > 0, m
    assert np.isfinite(m["tree_loss"]), m
    # BOTH gradient sets nonzero and finite — the joint capability
    assert m["gnorm_tree"] > 0 and np.isfinite(m["gnorm_tree"]), m
    assert m["gnorm_mat"] > 0 and np.isfinite(m["gnorm_mat"]), m
    # the step actually moved both parameter sets
    moved_tree = any(
        float(jnp.max(jnp.abs(a - b))) > 0
        for a, b in zip(jax.tree.leaves(new_state.tree_params),
                        jax.tree.leaves(state.tree_params)))
    assert moved_tree
    assert float(jnp.max(jnp.abs(new_state.mat_coeffs - state.mat_coeffs))) > 0


def test_rebuild_through_predicted_tree_renders(tiny):
    """The rebuilt (neural top-of-tree) scene must render identically to the
    SAH scene in expectation — here: same image for the same seeds, since the
    BVH only reorders primitives."""
    sc, dbvh, cam = tiny
    tree_cfg = treenet.TreeNetConfig(levels=2, capacity=8, pc_size=32)
    params = treenet.init_params(tree_cfg, jax.random.PRNGKey(1))
    sc2, dbvh2, _ = joint.rebuild_scene_with_predicted_tree(
        sc, params, tree_cfg, pc_size=tree_cfg.pc_size)
    cfg = integrator.IntegratorConfig(max_depth=2, mis=True, traversal="xla")
    img_a = np.asarray(integrator.render(sc, dbvh, cam, spp=2,
                                         sampler="independent", cfg=cfg))
    img_b = np.asarray(integrator.render(sc2, dbvh2, cam, spp=2,
                                         sampler="independent", cfg=cfg))
    np.testing.assert_allclose(img_a, img_b, atol=1e-4, rtol=1e-4)
