"""SAH kd-tree aggregate: host build + lockstep device traversal.

Counterpart of the reference's KdTreeAggregate (`cpu/aggregates.h:76`, build
`buildTree:91`, traversal `Intersect`): surface-area-heuristic splits over
primitive-bound edge candidates with the reference's cost model
(isectCost=5, traversalCost=1, emptyBonus=0.5), leaves hold index lists
(primitives can live in multiple leaves — unlike the BVH there is no
reorder). Traversal is the classic tmin/tmax interval stack walk expressed
as a vmapped lax.while_loop (the XLA analog of aggregates.cpp's
KdTreeAggregate::Intersect); the BVH (XLA walk or CUDA kernel) remains the
production path — this aggregate exists for parity and comparison.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import triangle
from .traverse import Hit

Array = jax.Array

ISECT_COST = 5.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5
MAX_PRIMS_LEAF = 8
MAX_DEPTH_CAP = 28
STACK = 48


class KdTree(NamedTuple):
    """Flattened kd-tree.

    node_data: (Nn, 4) f32 [split_pos | axis | above_child | n_prims]:
      axis in {0,1,2} -> interior (below child = self+1, above = above_child)
      axis == 3      -> leaf: above_child = first index into prim_idx,
                        n_prims entries
    prim_idx: (M,) i32 triangle indices (leaves may repeat prims).
    """

    node_data: np.ndarray
    prim_idx: np.ndarray
    bounds: np.ndarray  # (2,3)
    n_nodes: int
    max_leaf: int  # largest leaf prim count (static traversal scan bound)


def build_kdtree(prim_lo: np.ndarray, prim_hi: np.ndarray,
                 max_prims: int = MAX_PRIMS_LEAF) -> KdTree:
    n = len(prim_lo)
    max_depth = min(int(8 + 1.3 * np.log2(max(n, 2))), MAX_DEPTH_CAP)
    root_lo = prim_lo.min(0).astype(np.float32)
    root_hi = prim_hi.max(0).astype(np.float32)

    nodes: list = []
    prim_out: list = []

    def leaf(idx):
        me = len(nodes)
        nodes.append([0.0, 3.0, float(len(prim_out)), float(len(idx))])
        prim_out.extend(int(i) for i in idx)
        return me

    def build(idx, lo, hi, depth, bad_refines):
        if len(idx) <= max_prims or depth >= max_depth:
            return leaf(idx)
        # SAH over bound-edge candidates (aggregates.cpp buildTree :91)
        d = np.maximum(hi - lo, 0)
        inv_total = 1.0 / max(2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]),
                              1e-20)
        old_cost = ISECT_COST * len(idx)
        best = (None, None, np.inf)
        for axis in np.argsort(-d):
            axis = int(axis)
            o = [a for a in range(3) if a != axis]
            edges = np.concatenate([prim_lo[idx, axis], prim_hi[idx, axis]])
            kinds = np.concatenate([np.zeros(len(idx)), np.ones(len(idx))])
            order = np.lexsort((kinds, edges))
            edges, kinds = edges[order], kinds[order]
            n_below, n_above = 0, len(idx)
            for e, kind in zip(edges, kinds):
                if kind == 1:
                    n_above -= 1
                if lo[axis] < e < hi[axis]:
                    b_lo = e - lo[axis]
                    b_hi = hi[axis] - e
                    sa_b = 2 * (d[o[0]] * d[o[1]] + b_lo * (d[o[0]] + d[o[1]]))
                    sa_a = 2 * (d[o[0]] * d[o[1]] + b_hi * (d[o[0]] + d[o[1]]))
                    pb = sa_b * inv_total
                    pa = sa_a * inv_total
                    eb = EMPTY_BONUS if (n_below == 0 or n_above == 0) else 0.0
                    cost = (TRAV_COST + ISECT_COST * (1 - eb)
                            * (pb * n_below + pa * n_above))
                    if cost < best[2]:
                        best = (axis, float(e), cost)
                if kind == 0:
                    n_below += 1
            if best[0] is not None:
                break  # the reference retries other axes only when no split
        axis, pos, cost = best
        if axis is None or (cost > 4 * old_cost and len(idx) < 16):
            return leaf(idx)
        if cost > old_cost:
            bad_refines += 1
        if bad_refines == 3:
            return leaf(idx)
        below = idx[prim_lo[idx, axis] < pos]
        above = idx[prim_hi[idx, axis] > pos]
        me = len(nodes)
        nodes.append([pos, float(axis), 0.0, 0.0])
        lo_a = lo.copy()
        lo_a[axis] = pos
        hi_b = hi.copy()
        hi_b[axis] = pos
        build(below, lo, hi_b, depth + 1, bad_refines)
        nodes[me][2] = float(len(nodes))
        build(above, lo_a, hi, depth + 1, bad_refines)
        return me

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        build(np.arange(n), root_lo.copy(), root_hi.copy(), 0, 0)
    finally:
        sys.setrecursionlimit(old)
    node_arr = np.asarray(nodes, np.float32)
    leaf_rows = node_arr[:, 1] == 3.0
    max_leaf = int(node_arr[leaf_rows, 3].max()) if leaf_rows.any() else 1
    return KdTree(
        node_data=node_arr,
        prim_idx=np.asarray(prim_out if prim_out else [0], np.int32),
        bounds=np.stack([root_lo, root_hi]),
        n_nodes=len(nodes),
        max_leaf=max(max_leaf, 1),
    )


def _traverse_one(kt_nodes, kt_prims, kt_bounds, tri_p, o, d, t_max,
                  any_hit: bool, max_leaf_scan: int):
    """Single-ray kd traversal (KdTreeAggregate::Intersect) to be vmapped."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)
    # clip to the tree bounds
    t0s = (kt_bounds[0] - o) * inv_d
    t1s = (kt_bounds[1] - o) * inv_d
    g_tmin = jnp.maximum(jnp.max(jnp.minimum(t0s, t1s)), 0.0)
    g_tmax = jnp.minimum(jnp.min(jnp.maximum(t0s, t1s)), t_max)

    z = jnp.zeros_like(t_max) + o[0] * 0.0
    zi = z.astype(jnp.int32)
    init = (
        t_max + z,              # best t
        zi - 1,                 # prim
        z, z,                   # b1 b2
        zi,                     # node
        g_tmin + z, g_tmax + z,  # current interval
        zi,                     # sp
        jnp.zeros((STACK, 3), jnp.float32) + z,  # stack rows [node, tmin, tmax]
        (g_tmin > g_tmax) | (z > 1),             # done
    )

    def cond(s):
        return ~s[-1]

    def body(s):
        t, prim, b1, b2, node, tmin, tmax, sp, stack, done = s
        nd = jax.lax.dynamic_slice_in_dim(kt_nodes, node, 1, 0)[0]
        pos, axis_f, above, cnt = nd[0], nd[1], nd[2], nd[3]
        axis = axis_f.astype(jnp.int32)
        is_leaf = axis == 3

        # --- leaf: test its prims (bounded scan) --------------------------
        first = above.astype(jnp.int32)
        count = cnt.astype(jnp.int32)
        pidx = jax.lax.dynamic_slice_in_dim(
            kt_prims, jnp.maximum(first, 0), max_leaf_scan, 0)
        tris = tri_p[jnp.clip(pidx, 0, tri_p.shape[0] - 1)]
        th = triangle.intersect(
            o[None], d[None], jnp.broadcast_to(t, (max_leaf_scan,)),
            tris[:, 0], tris[:, 1], tris[:, 2])
        in_rng = jnp.arange(max_leaf_scan) < count
        ok = th.hit & in_rng
        tb = jnp.where(ok, th.t, jnp.inf)
        k = jnp.argmin(tb)
        better = is_leaf & (tb[k] < t)
        t = jnp.where(better, tb[k], t)
        prim = jnp.where(better, pidx[k], prim)
        b1 = jnp.where(better, th.b1[k], b1)
        b2 = jnp.where(better, th.b2[k], b2)

        # --- interior: interval split --------------------------------------
        oa = jnp.take(o, jnp.minimum(axis, 2))
        da = jnp.take(inv_d, jnp.minimum(axis, 2))
        t_plane = (pos - oa) * da
        below_first = (oa < pos) | ((oa == pos) & (da <= 0))
        first_child = jnp.where(below_first, node + 1, above.astype(jnp.int32))
        second_child = jnp.where(below_first, above.astype(jnp.int32), node + 1)
        only_first = (t_plane > tmax) | (t_plane <= 0)
        # the reference's else-if: only_first takes precedence when both hold
        # (tSplit <= 0 also satisfies tSplit < tMin), aggregates.cpp Intersect
        only_second = (t_plane < tmin) & ~only_first

        # push second child where both are traversed
        push = (~is_leaf) & ~only_first & ~only_second
        row = jnp.stack([second_child.astype(jnp.float32),
                         jnp.maximum(t_plane, tmin), tmax])
        cur = jax.lax.dynamic_slice_in_dim(stack, sp, 1, 0)[0]
        stack = jax.lax.dynamic_update_slice_in_dim(
            stack, jnp.where(push, row, cur)[None], sp, 0)
        sp = jnp.where(push, sp + 1, sp)

        node_next = jnp.where(only_second, second_child, first_child)
        tmin_next = jnp.where(only_second, jnp.maximum(t_plane, tmin), tmin)
        tmax_next = jnp.where(push, jnp.minimum(t_plane, tmax),
                              jnp.where(only_first, tmax, tmax))

        # leaf (or early any-hit): pop
        pop = is_leaf | (any_hit & (prim >= 0))
        empty = sp == 0
        sp2 = jnp.where(pop & ~empty, sp - 1, sp)
        popped = jax.lax.dynamic_slice_in_dim(stack, jnp.maximum(sp2, 0), 1, 0)[0]
        node = jnp.where(pop, popped[0].astype(jnp.int32), node_next)
        tmin = jnp.where(pop, popped[1], tmin_next)
        tmax = jnp.where(pop, popped[2], tmax_next)
        # early out when the best hit precedes the popped interval
        skip_done = pop & ~empty & (t < tmin)
        done = (pop & empty) | (any_hit & (prim >= 0)) | skip_done
        return (t, prim, b1, b2, node, tmin, tmax, sp2, stack, done)

    out = jax.lax.while_loop(cond, body, init)
    t, prim, b1, b2 = out[0], out[1], out[2], out[3]
    return Hit(t=jnp.where(prim >= 0, t, jnp.inf), prim=prim, b1=b1, b2=b2)


def intersect_closest(kt: KdTree, tri_p: Array, o: Array, d: Array,
                      t_max: Array) -> Hit:
    nodes = jnp.asarray(kt.node_data)
    prims = jnp.asarray(kt.prim_idx)
    bnds = jnp.asarray(kt.bounds)
    scan = -(-kt.max_leaf // 8) * 8
    f = lambda o_, d_, t_: _traverse_one(nodes, prims, bnds, tri_p, o_, d_,
                                         t_, False, scan)
    return jax.vmap(f)(o, d, t_max)


def intersect_any(kt: KdTree, tri_p: Array, o: Array, d: Array,
                  t_max: Array) -> Array:
    nodes = jnp.asarray(kt.node_data)
    prims = jnp.asarray(kt.prim_idx)
    bnds = jnp.asarray(kt.bounds)
    scan = -(-kt.max_leaf // 8) * 8
    f = lambda o_, d_, t_: _traverse_one(nodes, prims, bnds, tri_p, o_, d_,
                                         t_, True, scan)
    return jax.vmap(f)(o, d, t_max).prim >= 0
