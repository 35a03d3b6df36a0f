"""Joint renderer + treeNet training: ONE jitted program, sharded.

The reference couples its two halves offline through binary artifacts
(nss_model_test.py:37 exports a plane list; nn_tree_bench rebuilds a python
BVH). The north star (BASELINE.json) asks for the capability the fork never
built: the split learner and the differentiable renderer trained in the SAME
JAX program, with treeNet gradients and material/image gradients all-reduced
together over the device mesh.

Gradient topology (SURVEY.md §7.1 diff/):
- treeNet params <- differentiable SAH/EPO tree cost (splitter custom-VJP
  event gradients) over the scene's primitive cloud. Visibility is discrete,
  so the *render* does not backprop into the planes; the tree loss is the
  same surrogate the reference trains with (nss_loss).
- material params <- image loss through the wavefront renderer (shading path
  gradients, geometry detached).
- One value_and_grad over (tree_params, mat_coeffs); one psum over the mesh
  axis; one optimizer step. The forward render traverses a BVH whose
  top-of-tree came from the *previous* treeNet prediction (rebuilt host-side
  between outer steps — the discrete structure is the jit boundary).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import treenet, data as nn_data, export as nn_export
from ..core import samplers
from ..wavefront import integrator, film as film_mod
from ..scatter import lightsamplers

Array = jax.Array


def scene_cloud(scene, pc_size: int, batch: int, seed: int = 0) -> np.ndarray:
    """(batch, pc_size, 9) primitive clouds from a compiled scene's triangles
    (nss_data_stream.Scene style: stride-sampled, per-batch jitter)."""
    # exclude the lane-padding triangles (degenerate zeros past n_tris)
    prims = nn_data.tris_to_prims(np.asarray(scene.tri_p)[:scene.n_tris])
    n = len(prims)
    stride = max(1, n // pc_size)
    base = prims[::stride][:pc_size]
    if len(base) < pc_size:
        base = np.concatenate(
            [base, np.repeat(base[-1:], pc_size - len(base), 0)])
    rs = np.random.RandomState(seed)
    ext = np.abs(base).max() + 1e-6
    out = np.stack([
        base + (rs.randn(1, 9) * 0.01 * ext).astype(np.float32) * (b > 0)
        for b in range(batch)
    ])
    return np.asarray(out, np.float32)


class JointState(NamedTuple):
    tree_params: tuple
    mat_coeffs: Array


def make_joint_loss(tree_cfg: treenet.TreeNetConfig, cam, sampler_cfg,
                    render_cfg, tree_weight: float = 1.0,
                    # (early_exit forced off below: the loss runs under
                    # value_and_grad and lax.while_loop has no reverse rule)
                    target: Array | None = None, isect=None):
    """loss(state, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
    tables) -> (scalar, aux). Pure; shard-map/pjit friendly (no host
    callbacks). `isect` (dispatch.Intersectors of the current tree) is bound
    to the traced `tables`; without it the wave builds its own intersectors
    from the traced scene, which only the XLA walk supports."""
    render_cfg = render_cfg._replace(early_exit=False)

    def loss_fn(state: JointState, scene, dbvh, ls_tables, clouds,
                pixel_idx, sample_idx, tables=None):
        # --- render branch: image loss w.r.t. material coeffs -------------
        scn = scene.replace(mat_coeffs=state.mat_coeffs)
        L, lam, lam_pdf, fw = integrator.trace_wave(
            scn, dbvh, cam, sampler_cfg, render_cfg, pixel_idx, sample_idx,
            ls_tables, None if isect is None else isect.bind(tables))
        f = film_mod.make_film(cam.height, cam.width)
        f = film_mod.add_samples(f, pixel_idx, L, lam, lam_pdf,
                                 filter_weight=fw)
        if target is None:
            image_loss = jnp.sum(f.xyz) / (cam.height * cam.width)
        else:
            image_loss = jnp.mean((f.xyz - target) ** 2)

        # --- treeNet branch: differentiable SAH/EPO tree cost -------------
        tree_loss, aux = treenet.loss_fn(state.tree_params, tree_cfg, clouds)

        loss = image_loss + tree_weight * tree_loss
        return loss, {"image_loss": image_loss, "tree_loss": tree_loss}

    return loss_fn


def make_joint_step(tree_cfg, cam, sampler_cfg, render_cfg, mesh=None,
                    axis: str = "rays", lr: float = 1e-3,
                    tree_weight: float = 1.0, target=None, isect=None):
    """Returns step(state, scene, dbvh, ls_tables, clouds, pixel_idx, s_idx,
    tables) -> (state', metrics). When `mesh` is given, the caller shard_maps
    it with clouds+pixel_idx sharded over `axis`; the step psums loss+grads.
    `isect`/`tables` as in make_joint_loss."""
    loss_fn = make_joint_loss(tree_cfg, cam, sampler_cfg, render_cfg,
                              tree_weight, target, isect)

    def step(state: JointState, scene, dbvh, ls_tables, clouds, pixel_idx,
             sample_idx, tables=None):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state, scene, dbvh, ls_tables, clouds, pixel_idx, sample_idx,
            tables)
        if mesh is not None:
            loss = jax.lax.pmean(loss, axis)
            aux = jax.tree.map(lambda a: jax.lax.pmean(a, axis), aux)
            grads = jax.tree.map(lambda g: jax.lax.pmean(g, axis), grads)
        new_state = JointState(
            tree_params=jax.tree.map(lambda p, g: p - lr * g,
                                     state.tree_params, grads.tree_params),
            mat_coeffs=state.mat_coeffs - lr * grads.mat_coeffs,
        )
        gnorm_tree = jnp.sqrt(sum(
            jnp.sum(g * g) for g in jax.tree.leaves(grads.tree_params)))
        gnorm_mat = jnp.sqrt(jnp.sum(grads.mat_coeffs ** 2))
        metrics = dict(aux, loss=loss, gnorm_tree=gnorm_tree,
                       gnorm_mat=gnorm_mat)
        return new_state, metrics

    return step


def rebuild_scene_with_predicted_tree(scene, tree_params,
                                      tree_cfg: treenet.TreeNetConfig,
                                      pc_size: int = 256):
    """Host-side outer step: hard-predict the plane tree for this scene and
    rebuild the traversal BVH through it (learn.export.planes_to_bvh +
    accel.apply_bvh_to_scene). Returns (scene2, dbvh2, bvh2)."""
    from .. import accel

    cloud = scene_cloud(scene, pc_size, batch=1)
    _, planes = treenet.predict_tree(tree_params, tree_cfg,
                                     jnp.asarray(cloud))
    planes_np = np.asarray(planes[0])
    tri = np.asarray(scene.tri_p)[:scene.n_tris]
    bvh = nn_export.planes_to_bvh(tri, planes_np)
    return accel.apply_bvh_to_scene(scene, bvh)
