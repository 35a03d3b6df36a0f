"""kd-tree reference builder, callbacks, and procedural-noise tests."""

import os

import numpy as np
import jax.numpy as jnp

from nn_bvh.learn import data, kd_tree, callbacks, trainer, treenet
from nn_bvh.utils import noise


def _prims(n=64, seed=0):
    sc = data.random_scene(n_meshes=2, prims_per_mesh=n // 2, seed=seed)
    return sc.base_cloud()


def test_greedy_kdtree_near_optimal_split():
    prims = _prims(128)
    greedy = kd_tree.build_greedy(prims, levels=3, n_bins=16)
    g1 = kd_tree.KdTree(planes=greedy.planes[:1], levels=1)
    cost_g = kd_tree.tree_cost(g1, prims)
    lo, hi = kd_tree._bounds_of(prims)
    ax = int(np.argmax(hi - lo))

    def plane_cost(axis, off):
        t = kd_tree.KdTree(
            planes=[np.asarray([[axis, off]], np.float32)], levels=1)
        return kd_tree.tree_cost(t, prims)

    # within discretization error of the exact midpoint split, and clearly
    # better than a lopsided split
    assert cost_g <= 1.02 * plane_cost(ax, 0.5 * (lo + hi)[ax])
    assert cost_g < 0.95 * plane_cost(ax, lo[ax] + 0.05 * (hi - lo)[ax])


def test_kdtree_vh_strategy_runs():
    prims = _prims(64)
    t = kd_tree.build_greedy(prims, levels=2, strategy=kd_tree.VH, n_bins=8)
    c = kd_tree.tree_cost(t, prims, strategy=kd_tree.VH)
    assert np.isfinite(c) and c > 0


def test_level_order_roundtrip():
    prims = _prims(64)
    t = kd_tree.build_greedy(prims, levels=3, n_bins=8)
    flat = kd_tree.to_level_order(t)
    assert flat.shape == (1 + 2 + 4, 4)
    t2 = kd_tree.from_level_order(flat)
    assert kd_tree.abs_diff(t, t2) < 1e-6
    # preorder -> levelorder permutes correctly (root stays first)
    pre = np.arange(7 * 4, dtype=np.float32).reshape(7, 4)
    lvl = kd_tree.preorder_to_levelorder(pre, 3)
    assert np.allclose(lvl[0], pre[0])
    assert np.allclose(lvl[1], pre[1])      # first child of root
    assert np.allclose(lvl[2], pre[4])      # right subtree root


def test_train_with_callback(tmp_path):
    cfg = treenet.TreeNetConfig(levels=3, capacity=8, pc_size=32,
                                learning_rate=3e-4)
    sc = data.random_scene(n_meshes=2, prims_per_mesh=16, seed=1)
    log = callbacks.TrainLog(cfg, str(tmp_path),
                             test_clouds=sc.next_batch(2))
    state, hist = trainer.train(cfg, sc, n_steps=4, batch_size=2,
                                log_every=2, callback=log)
    assert os.path.exists(os.path.join(str(tmp_path), "treenet_log.csv"))
    assert os.path.exists(os.path.join(str(tmp_path), "treenet_best.pkl"))
    assert any("test_cost" in r for r in log.rows)
    assert all(np.isfinite(r.get("test_cost", 0.0)) for r in log.rows)


def test_perlin_noise_properties():
    rs = np.random.RandomState(0)
    p = rs.rand(2048, 3).astype(np.float32) * 40
    n = noise.perlin(p)
    assert np.all(np.abs(n) <= 1.3)
    assert abs(float(n.mean())) < 0.03       # zero-mean
    assert float(n.std()) > 0.05             # non-degenerate
    # lattice points evaluate to 0 (gradient noise property)
    lat = noise.perlin(np.asarray([[1.0, 2.0, 3.0], [5.0, 0.0, 7.0]]))
    assert np.allclose(lat, 0.0, atol=1e-5)


def test_procedural_texture_bake():
    from nn_bvh.geometry import scene as scene_mod

    b = scene_mod.SceneBuilder()
    for kind in ("fbm", "wrinkled", "windy", "marble", "dots"):
        tid = b.add_texture_procedural(kind, scale=6.0, octaves=4)
        img = b._textures[tid]
        assert img.shape == (scene_mod.TEX_RES, scene_mod.TEX_RES, 3)
        assert np.isfinite(img).all() and img.min() >= 0
        assert img.std() > 0.01  # real spatial variation


def test_pointcloud_stream_csv(tmp_path):
    """nss CSV point-cloud stream (nss_data_stream.py:18 counterpart)."""
    import numpy as np
    from nn_bvh.learn.data import PointCloudStream

    root = tmp_path / "pcs"
    root.mkdir()
    rs = np.random.RandomState(0)
    names = []
    for i in range(4):
        pc = rs.rand(64, 3).astype(np.float32) * (i + 1)
        np.savez(root / f"frag{i}.npz", a=pc)
        names.append(f"frag{i}")
    # one degenerate (tiny volume) cloud that must be filtered out
    np.savez(root / "flat.npz", a=np.zeros((64, 3), np.float32))
    names.append("flat")
    csv_p = tmp_path / "index.csv"
    csv_p.write_text("samples\n" + "\n".join(names) + "\n")

    stream = PointCloudStream(str(root), str(csv_p), batch_size=2)
    assert len(stream.clouds) == 4  # degenerate filtered
    assert stream.batches_per_epoch() == 2
    nm, batch = next(iter(stream))
    assert batch.shape == (2, 64, 3)
    # normalized into the [1,2] cube (nss applyNormalization semantics)
    assert batch.min() >= 1.0 - 1e-6 and batch.max() <= 2.0 + 1e-6
