"""Native C++ BVH builder: parity with the numpy builder + traversal checks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nn_bvh import accel, native
from nn_bvh.accel import build as build_mod
from nn_bvh.accel.traverse import DeviceBVH


def _random_prims(n, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.rand(n, 3).astype(np.float32) * 10
    e = rs.rand(n, 3).astype(np.float32) * 0.5
    return c - e, c + e


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_builder_matches_numpy_quality():
    lo, hi = _random_prims(5000)
    b_np = build_mod.build_sah(lo, hi)
    b_cc = native.build_sah_native(lo, hi)
    assert b_cc is not None
    # valid reorder permutation
    assert sorted(b_cc.prim_order.tolist()) == list(range(5000))
    # root bounds identical
    assert np.allclose(b_cc.node_lo[0], b_np.node_lo[0], atol=1e-5)
    assert np.allclose(b_cc.node_hi[0], b_np.node_hi[0], atol=1e-5)
    # leaves cover every prim exactly once
    leaf = b_cc.node_meta[b_cc.node_meta[:, 1] > 0]
    covered = np.zeros(5000, bool)
    for off, cnt, _ in leaf:
        assert not covered[off:off + cnt].any()
        covered[off:off + cnt] = True
        assert cnt <= build_mod.MAX_LEAF_PRIMS
    assert covered.all()
    # SAH cost parity within 10% (tie-breaking differs)
    c_np = build_mod.sah_cost(b_np)
    c_cc = build_mod.sah_cost(b_cc)
    assert abs(c_cc - c_np) / c_np < 0.10, (c_cc, c_np)
    # native cost metric agrees with the python metric on the same tree
    c_cc2 = native.sah_cost_native(b_cc)
    assert abs(c_cc2 - c_cc) / c_cc < 1e-4, (c_cc2, c_cc)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_bvh_traversal_correct():
    """Rays through a native-built BVH hit exactly what brute force hits."""
    rs = np.random.RandomState(1)
    n = 400
    v0 = rs.rand(n, 3).astype(np.float32) * 8
    tri = np.stack([v0, v0 + rs.rand(n, 3) * 0.8, v0 + rs.rand(n, 3) * 0.8], 1)
    tri = np.concatenate([tri, np.zeros((112, 3, 3), np.float32)])  # pad 512
    lo, hi = build_mod.triangle_bounds(tri[:n])
    bvh = native.build_sah_native(lo, hi)
    tri_r = tri.copy()
    tri_r[:n] = tri[:n][bvh.prim_order]
    dbvh = DeviceBVH(node_lo=jnp.asarray(bvh.node_lo),
                     node_hi=jnp.asarray(bvh.node_hi),
                     node_meta=jnp.asarray(bvh.node_meta),
                     n_nodes=int(bvh.n_nodes))
    tp = jnp.asarray(tri_r)
    R = 256
    o = jnp.asarray(rs.rand(R, 3) * 8, jnp.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tm = jnp.full((R,), 1e30)
    hb = accel.intersect_brute(tp, o, d, tm)
    hc = accel.intersect_closest(dbvh, tp, o, d, tm)
    np.testing.assert_allclose(np.asarray(hc.t), np.asarray(hb.t), rtol=1e-4)
    assert np.array_equal(np.asarray(hc.prim) >= 0, np.asarray(hb.prim) >= 0)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_scene_build_uses_native():
    from nn_bvh.geometry import scene as scene_mod

    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse")
    rs = np.random.RandomState(2)
    for _ in range(6):
        b.add_sphere(rs.rand(3) * 4, 0.5, m, n_theta=6, n_phi=12)
    sc = b.build()
    sc2, dbvh, bvh = accel.build_scene_bvh(sc, method="sah")
    assert bvh.n_nodes > 1
    # reordered scene renders identically to brute force on a few rays
    o = jnp.asarray([[0.0, 0.0, -10.0]] * 4)
    d = jnp.asarray([[0.05, 0.1, 1.0], [0.0, 0.0, 1.0],
                     [0.2, 0.2, 1.0], [-0.1, 0.3, 1.0]])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tm = jnp.full((4,), 1e30)
    tp = jnp.asarray(sc2.tri_p)
    hb = accel.intersect_brute(tp, o, d, tm)
    hc = accel.intersect_closest(jax.tree.map(jnp.asarray, dbvh), tp, o, d, tm)
    np.testing.assert_allclose(np.asarray(hc.t), np.asarray(hb.t), rtol=1e-4)
