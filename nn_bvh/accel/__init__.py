"""Acceleration structures: host build + device traversal."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import build as _build
from . import traverse as _traverse
from .build import BVH, build_sah, build_median, triangle_bounds, sah_cost
from .traverse import DeviceBVH, Hit, intersect_closest, intersect_any, intersect_brute, upload


def build_scene_bvh(scene, method: str = "sah"):
    """Build a BVH over a CompiledScene and reorder its triangles so leaves are
    contiguous ranges (the reference reorders primitives the same way,
    aggregates.cpp:192 orderedPrims). Returns (scene_reordered, DeviceBVH, BVH).
    """
    n = scene.n_tris
    tri_p = np.asarray(scene.tri_p)[:n]
    lo, hi = triangle_bounds(tri_p)
    if scene.tri_p_end is not None:
        # animated scenes: ONE conservative tree over the union of both
        # shutter keyframes' prim bounds (AnimatedPrimitive Bounds(),
        # cpu/primitive.h:33 unions over shutter time)
        lo2, hi2 = triangle_bounds(np.asarray(scene.tri_p_end)[:n])
        lo, hi = np.minimum(lo, lo2), np.maximum(hi, hi2)
    if method in ("sah", "sah_native"):
        # prefer the native C++ builder (native/bvh_builder.cpp — the
        # reference also builds its BVH in native code, cpu/aggregates.cpp);
        # same flattened layout, ~50x faster than the numpy path on big
        # scenes. Falls back to numpy without a toolchain.
        from .. import native as _native

        bvh = _native.build_sah_native(lo, hi, max_leaf=_build.MAX_LEAF_PRIMS)
        if bvh is None:
            bvh = build_sah(lo, hi)
    else:
        builder = {"sah_numpy": build_sah, "median": build_median,
                   "lbvh": build_median}[method]
        bvh = builder(lo, hi)
    return apply_bvh_to_scene(scene, bvh)


def apply_bvh_to_scene(scene, bvh: BVH):
    """Reorder a CompiledScene's triangles to match a (possibly learned) BVH's
    leaf layout and return (scene_reordered, host DeviceBVH, bvh). This is how
    a treeNet-predicted tree (learn.export.planes_to_bvh) plugs into the
    renderer — the neural-BVH <-> renderer coupling the reference never wired
    up (SURVEY.md §0)."""
    n = scene.n_tris
    assert len(bvh.prim_order) == n, (len(bvh.prim_order), n)
    order = bvh.prim_order  # (n,) original index per new slot
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)

    def perm(x):
        x = np.asarray(x)
        out = x.copy()
        out[:n] = x[:n][order]
        return out

    light_params = np.asarray(scene.light_params).copy()
    if len(light_params):
        area_mask = np.asarray(scene.light_type) == 3  # LIGHT_AREA_TRI
        old_tri = light_params[area_mask, 0].astype(np.int64)
        light_params[area_mask, 0] = inv[old_tri].astype(np.float32)

    # everything stays host-side numpy; renderers upload once via
    # scene.to_device / tree.map(jnp.asarray)
    scene2 = scene.replace(
        tri_p=perm(scene.tri_p),
        tri_n=perm(scene.tri_n),
        tri_uv=perm(scene.tri_uv),
        tri_mat=perm(scene.tri_mat),
        tri_light=perm(scene.tri_light),
        light_params=light_params,
        tri_med_inside=(perm(scene.tri_med_inside)
                        if scene.tri_med_inside is not None else None),
        tri_med_outside=(perm(scene.tri_med_outside)
                         if scene.tri_med_outside is not None else None),
        tri_p_end=(perm(scene.tri_p_end)
                   if scene.tri_p_end is not None else None),
        tri_n_end=(perm(scene.tri_n_end)
                   if scene.tri_n_end is not None else None),
    )
    from ..geometry import scene as _scene_mod

    scene2 = scene2.replace(tri_shade=_scene_mod.make_tri_shade(scene2))
    if scene2.tri_p_end is not None:
        scene2 = scene2.replace(
            tri_shade_end=_scene_mod.make_tri_shade(scene2, use_end=True))
    dbvh_host = _traverse.DeviceBVH(
        node_lo=bvh.node_lo, node_hi=bvh.node_hi, node_meta=bvh.node_meta,
        n_nodes=int(bvh.n_nodes),
    )
    return scene2, dbvh_host, bvh
