"""Shared tensor ops for the neural spatial-split (treeNet) learner.

JAX rebuild of the fork's ML framework (`machine_learning/nss_*`,
derived from cgaueb/nss). Conventions:

- SAH/point variant: clouds are (B, N, 3) point clouds.
- EPO/primitive variant: clouds are (B, N, 9) primitive clouds
  (x1 x2 x3 | y1 y2 y3 | z1 z2 z3 vertex layout, nn_types.py Primitive3).
- node axes are vectorized: where the reference loops Python nodes and calls
  per-node TF ops (nss_neural_spatial_split.py:188-240), we carry a K-node
  axis (K = 6^level) and run every node of a level in one fused op — the
  per-level encoder becomes a single big einsum batch.
- bounds are (..., 6) = [min_xyz | max_xyz] like the reference.

Masked reductions use inf-fills instead of the reference's beta-offset trick
(nss_tree_modules.py:343 `reduce_min(|x - beta|) + beta`), which assumed
scene coordinates in [1,2]; the semantics are identical, without the domain
restriction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

BIG = 1e9


def build_mask_points(points: Array, bounds: Array) -> Array:
    """Points-in-box mask (nss_tree_common.build_mask). points (..., N, 3),
    bounds (..., 6) -> (..., N) float 0/1. Gradient-stopped like the reference."""
    bmin = bounds[..., None, 0:3]
    bmax = bounds[..., None, 3:6]
    inside = jnp.all((points >= bmin) & (points <= bmax), axis=-1)
    return jax.lax.stop_gradient(inside.astype(jnp.float32))


def prim_axis_points(prims: Array, axis: int) -> Array:
    """(..., N, 9) primitive cloud -> (..., N, 3) per-vertex coords along axis
    (nss_tree_modules.get_axis_points with a static axis index)."""
    return jax.lax.slice_in_dim(prims, 3 * axis, 3 * axis + 3, axis=-1)


def prim_vertices(prims: Array) -> Array:
    """(..., N, 9) -> (..., N, 3, 3) [vertex, xyz]."""
    x = prims[..., 0:3]
    y = prims[..., 3:6]
    z = prims[..., 6:9]
    return jnp.stack([x, y, z], axis=-1)  # (..., N, 3 verts, 3 xyz)


def prim_mids(prims: Array, axis: int) -> Array:
    """Primitive midpoint along axis: (min+max)/2 over the 3 vertices."""
    ap = prim_axis_points(prims, axis)
    return 0.5 * (jnp.min(ap, axis=-1) + jnp.max(ap, axis=-1))


def build_mask_epo(prims: Array, offset: Array, axis: int, parent_mask: Array,
                   is_right: bool) -> Array:
    """Primitive-midpoint classification mask (nss_tree_common.build_mask_EPO_):
    left child keeps prims with offset >= mid, right keeps offset < mid."""
    mids = prim_mids(prims, axis)
    side = (offset < mids) if is_right else (offset >= mids)
    return jax.lax.stop_gradient(parent_mask * side.astype(jnp.float32))


def surface_area_bounds(bounds: Array) -> Array:
    """SAH area of (..., 6) bounds (nss_tree_modules.sah_eval.area)."""
    d = bounds[..., 3:6] - bounds[..., 0:3]
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def volume_bounds(bounds: Array, r_eps: float = 1e-4) -> Array:
    d = (bounds[..., 3:6] + r_eps) - (bounds[..., 0:3] - r_eps)
    return d[..., 0] * d[..., 1] * d[..., 2]


def prim_areas(prims: Array) -> Array:
    """(..., N, 9) -> (..., N) triangle surface areas
    (nss_tree_modules.surface_prims_EPO, per-prim before the sum)."""
    v = prim_vertices(prims)  # (..., N, 3 verts, 3 xyz)
    p1 = v[..., 0, :]
    p2 = v[..., 1, :]
    p3 = v[..., 2, :]
    u = jnp.cross(p2 - p1, p3 - p1)
    return 0.5 * jnp.linalg.norm(u, axis=-1)


def masked_min(x: Array, mask: Array, axis: int = -1) -> Array:
    return jnp.min(jnp.where(mask > 0, x, BIG), axis=axis)


def masked_max(x: Array, mask: Array, axis: int = -1) -> Array:
    return jnp.max(jnp.where(mask > 0, x, -BIG), axis=axis)


def cloud_bounds(cloud: Array) -> Array:
    """Root bounds of a cloud: (..., N, 3) points or (..., N, 9) prims -> (..., 6)."""
    if cloud.shape[-1] == 3:
        bmin = jnp.min(cloud, axis=-2)
        bmax = jnp.max(cloud, axis=-2)
    else:
        v = prim_vertices(cloud)  # (..., N, 3, 3)
        bmin = jnp.min(v, axis=(-3, -2))
        bmax = jnp.max(v, axis=(-3, -2))
    return jnp.concatenate([bmin, bmax], axis=-1)
