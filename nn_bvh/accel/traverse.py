"""XLA reference BVH traversal (per-ray stack walk under vmap).

Semantics anchor: the reference's `BVHAggregate::Intersect` / `IntersectP`
(`cpu/aggregates.cpp:529,581`) — 64-deep stack, dirIsNeg-ordered front-to-back
descent, shrinking t_max. This version expresses that walk as a
`lax.while_loop` per ray and vmaps over the batch; XLA compiles the node fetch
as dynamic-slice. It is the CPU traversal and the plain reference the CUDA
BVH4 kernel (cuda_bvh4.py) is checked against.

Also provides brute-force intersection (all rays x all triangles) for tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import triangle

Array = jax.Array

STACK_DEPTH = 64


class Hit(NamedTuple):
    t: Array        # inf if miss
    prim: Array     # i32 triangle id (post-reorder), -1 if miss
    b1: Array       # barycentric coords of hit
    b2: Array

    @property
    def valid(self):
        return self.prim >= 0


class DeviceBVH(NamedTuple):
    """Device-resident flat BVH (upload of accel.build.BVH)."""

    node_lo: Array    # (Nn, 3) f32
    node_hi: Array    # (Nn, 3) f32
    node_meta: Array  # (Nn, 3) i32 [offset, count, axis]
    n_nodes: int


from ..utils.pytree import register_static as _register_static

_register_static(DeviceBVH, ("n_nodes",))


def upload(bvh) -> DeviceBVH:
    return DeviceBVH(
        node_lo=jnp.asarray(bvh.node_lo),
        node_hi=jnp.asarray(bvh.node_hi),
        node_meta=jnp.asarray(bvh.node_meta),
        n_nodes=int(bvh.n_nodes),
    )


def _slab(o, inv_d, t_max, lo, hi):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1))
    tf = jnp.min(jnp.maximum(t0, t1)) * 1.0000004
    return (tn <= tf) & (tf > 0) & (tn < t_max)


def _traverse_one(bvh: DeviceBVH, tri_p: Array, o: Array, d: Array, t_max: Array,
                  any_hit: bool, max_leaf: int):
    """Single-ray stack traversal (to be vmapped)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    dir_is_neg = (inv_d < 0).astype(jnp.int32)

    def cond(state):
        t, prim, b1, b2, node, sp, stack, done = state
        return ~done

    def body(state):
        t, prim, b1, b2, node, sp, stack, done = state
        meta = jax.lax.dynamic_slice_in_dim(bvh.node_meta, node, 1, 0)[0]
        lo = jax.lax.dynamic_slice_in_dim(bvh.node_lo, node, 1, 0)[0]
        hi = jax.lax.dynamic_slice_in_dim(bvh.node_hi, node, 1, 0)[0]
        offset, count, axis = meta[0], meta[1], meta[2]
        hit_box = _slab(o, inv_d, t, lo, hi)
        is_leaf = count > 0

        # --- leaf: bounded triangle loop (always executed, mask-selected;
        # lockstep lanes make lax.cond useless on a vector machine anyway) ---
        do_leaf = hit_box & is_leaf
        tris = jax.lax.dynamic_slice_in_dim(tri_p, jnp.maximum(offset, 0), max_leaf, 0)
        th = triangle.intersect(
            o[None], d[None], jnp.broadcast_to(t, (max_leaf,)),
            tris[:, 0], tris[:, 1], tris[:, 2],
        )
        in_range = jnp.arange(max_leaf) < count
        ok = th.hit & in_range
        tbest = jnp.where(ok, th.t, jnp.inf)
        k = jnp.argmin(tbest)
        better = do_leaf & (tbest[k] < t)
        t = jnp.where(better, tbest[k], t)
        prim = jnp.where(better, offset + k.astype(jnp.int32), prim)
        b1 = jnp.where(better, th.b1[k], b1)
        b2 = jnp.where(better, th.b2[k], b2)

        # --- interior: push far child, descend near child ------------------
        descend = hit_box & ~is_leaf
        neg = dir_is_neg[axis] == 1
        near = jnp.where(neg, offset, node + 1)
        far = jnp.where(neg, node + 1, offset)
        cur = jax.lax.dynamic_index_in_dim(stack, sp, 0, keepdims=False)
        stack = jax.lax.dynamic_update_index_in_dim(
            stack, jnp.where(descend, far, cur), sp, 0
        )
        sp = jnp.where(descend, sp + 1, sp)

        # next node: descend near, else pop
        pop = ~descend
        empty = sp == 0
        sp = jnp.where(pop & ~empty, sp - 1, sp)
        popped = stack[jnp.maximum(sp, 0)]
        node = jnp.where(descend, near, popped)
        done = (pop & empty) | (any_hit & (prim >= 0))
        return (t, prim, b1, b2, node, sp, stack, done)

    # derive the init carry from the ray origin so every component carries the
    # same device-varying axes as the inputs (shard_map vma rules reject
    # constant carries mixed with varying loop bodies; t_max alone may itself
    # be a broadcast constant)
    z = jnp.zeros_like(t_max) + o[0] * 0.0
    zi = z.astype(jnp.int32)
    init = (
        t_max + z,
        zi - 1,
        z,
        z,
        zi,
        zi,
        jnp.zeros((STACK_DEPTH,), jnp.int32) + zi,
        z > jnp.inf,  # False
    )
    t, prim, b1, b2, *_ = jax.lax.while_loop(cond, body, init)
    # misses must report t = inf, not the (finite) t_max they carried
    return Hit(t=jnp.where(prim >= 0, t, jnp.inf), prim=prim, b1=b1, b2=b2)


def intersect_closest(bvh: DeviceBVH, tri_p: Array, o: Array, d: Array, t_max: Array,
                      max_leaf: int = None) -> Hit:
    """Closest-hit for a ray batch. o,d: (R,3); t_max: (R,)."""
    if max_leaf is None:
        from .build import MAX_LEAF_PRIMS as max_leaf  # noqa: F811
    f = lambda o_, d_, t_: _traverse_one(bvh, tri_p, o_, d_, t_, False, max_leaf)
    return jax.vmap(f)(o, d, t_max)


def intersect_any(bvh: DeviceBVH, tri_p: Array, o: Array, d: Array, t_max: Array,
                  max_leaf: int = None) -> Array:
    """Shadow-ray occlusion test (IntersectP, aggregates.cpp:581). Returns bool (R,)."""
    if max_leaf is None:
        from .build import MAX_LEAF_PRIMS as max_leaf  # noqa: F811
    f = lambda o_, d_, t_: _traverse_one(bvh, tri_p, o_, d_, t_, True, max_leaf)
    return jax.vmap(f)(o, d, t_max).prim >= 0


def intersect_brute(tri_p: Array, o: Array, d: Array, t_max: Array) -> Hit:
    """O(R*N) reference intersector for correctness tests."""
    th = triangle.intersect(
        o[:, None], d[:, None], t_max[:, None],
        tri_p[None, :, 0], tri_p[None, :, 1], tri_p[None, :, 2],
    )
    t = jnp.where(th.hit, th.t, jnp.inf)
    k = jnp.argmin(t, axis=1)
    r = jnp.arange(o.shape[0])
    tk = t[r, k]
    hit = jnp.isfinite(tk)
    return Hit(
        t=jnp.where(hit, tk, jnp.inf),
        prim=jnp.where(hit, k.astype(jnp.int32), -1),
        b1=th.b1[r, k],
        b2=th.b2[r, k],
    )
