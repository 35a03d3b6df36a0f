"""BVH build + traversal correctness vs brute force.

Mirrors the reference's watertightness fuzzing idiom (shapes_test.cpp:492):
random rays against random geometry, BVH result must match the O(N*R)
reference intersector exactly (same prim, same t)."""

import numpy as np
import jax
import jax.numpy as jnp

from nn_bvh import accel
from nn_bvh.accel import build as bvh_build
from nn_bvh.geometry import scene as scene_mod, triangle


def random_tris(n, seed=0, spread=4.0, size=0.4):
    rs = np.random.RandomState(seed)
    base = (rs.rand(n, 1, 3) - 0.5) * 2 * spread
    offs = (rs.rand(n, 3, 3) - 0.5) * 2 * size
    return (base + offs).astype(np.float32)


def random_rays(r, seed=1, spread=6.0):
    rs = np.random.RandomState(seed)
    o = ((rs.rand(r, 3) - 0.5) * 2 * spread).astype(np.float32)
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


class TestBVHBuild:
    def test_sah_structure(self):
        tri = random_tris(500)
        lo, hi = accel.triangle_bounds(tri)
        bvh = accel.build_sah(lo, hi)
        # permutation covers all prims
        assert sorted(bvh.prim_order.tolist()) == list(range(500))
        meta = bvh.node_meta
        leaves = meta[meta[:, 1] > 0]
        assert leaves[:, 1].sum() == 500
        assert leaves[:, 1].max() <= bvh_build.MAX_LEAF_PRIMS
        # leaf ranges are disjoint and sorted in DFS order
        starts = leaves[:, 0]
        assert len(np.unique(starts)) == len(starts)
        # root bounds contain all prim bounds
        assert np.all(bvh.node_lo[0] <= lo.min(0) + 1e-5)
        assert np.all(bvh.node_hi[0] >= hi.max(0) - 1e-5)
        # child bounds nested in parent (walk: first child = i+1)
        for i in range(bvh.n_nodes):
            if meta[i, 1] == 0:
                for c in (i + 1, meta[i, 0]):
                    assert np.all(bvh.node_lo[c] >= bvh.node_lo[i] - 1e-5)
                    assert np.all(bvh.node_hi[c] <= bvh.node_hi[i] + 1e-5)

    def test_median_structure(self):
        tri = random_tris(300, seed=3)
        lo, hi = accel.triangle_bounds(tri)
        bvh = accel.build_median(lo, hi)
        assert sorted(bvh.prim_order.tolist()) == list(range(300))
        meta = bvh.node_meta
        assert meta[meta[:, 1] > 0][:, 1].sum() == 300

    def test_sah_cost_sane(self):
        tri = random_tris(2000, seed=5)
        lo, hi = accel.triangle_bounds(tri)
        sah = accel.sah_cost(accel.build_sah(lo, hi))
        med = accel.sah_cost(accel.build_median(lo, hi))
        assert sah > 0 and med > 0
        # SAH should beat (or match) median-split quality
        assert sah <= med * 1.1


class TestTraversal:
    def _check(self, n_tri, n_ray, builder, seed=0):
        tri = random_tris(n_tri, seed=seed)
        lo, hi = accel.triangle_bounds(tri)
        bvh = builder(lo, hi)
        tri_sorted = jnp.asarray(tri[bvh.prim_order])
        dbvh = accel.upload(bvh)
        o, d = random_rays(n_ray, seed=seed + 10)
        t_max = jnp.full(n_ray, 1e9, jnp.float32)
        h = accel.intersect_closest(dbvh, tri_sorted, o, d, t_max)
        hb = accel.intersect_brute(tri_sorted, o, d, t_max)
        # same hit/miss classification
        np.testing.assert_array_equal(np.asarray(h.prim >= 0), np.asarray(hb.prim >= 0))
        hit = np.asarray(hb.prim >= 0)
        # same t (prims may differ only for exactly-equal t; compare t)
        np.testing.assert_allclose(
            np.asarray(h.t)[hit], np.asarray(hb.t)[hit], rtol=1e-5
        )
        hit_frac = hit.mean()
        assert hit_frac > 0.05  # scene dense enough to be a meaningful test
        # any-hit agrees with closest-hit occlusion
        occ = accel.intersect_any(dbvh, tri_sorted, o, d, t_max)
        np.testing.assert_array_equal(np.asarray(occ), hit)

    def test_sah_vs_brute(self):
        self._check(400, 256, accel.build_sah, seed=0)

    def test_median_vs_brute(self):
        self._check(400, 256, accel.build_median, seed=1)

    def test_tmax_respected(self):
        tri = random_tris(200, seed=2)
        lo, hi = accel.triangle_bounds(tri)
        bvh = accel.build_sah(lo, hi)
        tri_sorted = jnp.asarray(tri[bvh.prim_order])
        dbvh = accel.upload(bvh)
        o, d = random_rays(128, seed=12)
        far = accel.intersect_closest(dbvh, tri_sorted, o, d, jnp.full(128, 1e9, jnp.float32))
        # clamp t_max below each hit -> must miss
        t_clamp = jnp.where(jnp.isfinite(far.t), far.t * 0.5, 1e-3)
        near = accel.intersect_closest(dbvh, tri_sorted, o, d, t_clamp)
        hit = np.asarray(far.prim >= 0)
        # clamping t_max below the first hit must turn those rays into misses
        near_prim = np.asarray(near.prim)
        assert np.all(near_prim[hit] == -1)
        assert np.all(np.isinf(np.asarray(near.t)[hit]))


class TestSceneBVH:
    def test_scene_reorder_consistency(self):
        b = scene_mod.SceneBuilder()
        m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
        b.add_sphere((0, 0, 0), 1.0, m, n_theta=8, n_phi=12)
        b.add_quad((-2, -2, -1.5), (2, -2, -1.5), (2, 2, -1.5), (-2, 2, -1.5), m,
                   emission_rgb=(1, 1, 1), emission_scale=2.0)
        sc = b.build()
        sc2, dbvh, bvh = accel.build_scene_bvh(sc)
        # area lights still point at emissive triangles after the reorder
        lp = np.asarray(sc2.light_params)
        lt = np.asarray(sc2.light_type)
        for li in np.nonzero(lt == scene_mod.LIGHT_AREA_TRI)[0]:
            ti = int(lp[li, 0])
            assert int(np.asarray(sc2.tri_light)[ti]) == li
        # emissive quad geometry unchanged as a set
        p1 = np.sort(np.asarray(sc.tri_p[: sc.n_tris]).reshape(-1, 9), axis=0)
        p2 = np.sort(np.asarray(sc2.tri_p[: sc2.n_tris]).reshape(-1, 9), axis=0)
        np.testing.assert_allclose(p1, p2)


def test_kdtree_aggregate_matches_brute():
    """SAH kd-tree build + traversal hit-parity with brute force
    (KdTreeAggregate, cpu/aggregates.h:76)."""
    import numpy as np
    import jax.numpy as jnp
    from nn_bvh import accel
    from nn_bvh.accel import kdtree, build as bm

    rs = np.random.RandomState(5)
    n = 300
    v0 = rs.rand(n, 3).astype(np.float32) * 6
    tri = np.stack([v0, v0 + rs.rand(n, 3) * 0.7, v0 + rs.rand(n, 3) * 0.7], 1)
    lo, hi = bm.triangle_bounds(tri)
    kt = kdtree.build_kdtree(lo, hi)
    assert kt.n_nodes > 3
    tp = jnp.asarray(tri)
    R = 256
    o = jnp.asarray(rs.rand(R, 3) * 6, jnp.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tm = jnp.full((R,), 1e30)
    hb = accel.intersect_brute(tp, o, d, tm)
    hk = kdtree.intersect_closest(kt, tp, o, d, tm)
    np.testing.assert_allclose(np.asarray(hk.t), np.asarray(hb.t), rtol=2e-4)
    assert np.array_equal(np.asarray(hk.prim) >= 0, np.asarray(hb.prim) >= 0)
    # any-hit agrees on occlusion with finite t_max
    tm2 = jnp.full((R,), 1.5)
    occ_b = np.isfinite(np.asarray(accel.intersect_brute(tp, o, d, tm2).t))
    occ_k = np.asarray(kdtree.intersect_any(kt, tp, o, d, tm2))
    assert np.array_equal(occ_b, occ_k)
