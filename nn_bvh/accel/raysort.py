"""Ray coherence sort for wavefront batches (SURVEY.md §7.3).

Sorting rays by (dead, direction octant, origin Morton cell) clusters lanes
that walk similar parts of the BVH. The wavefront integrators sort their lane
state once per bounce (`IntegratorConfig.resort`); `make_sorted_isect` wraps a
single intersector call for standalone batches (AO, G-buffer, subsurface
probes, tools).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def _expand_bits6(v: Array) -> Array:
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def ray_sort_key(o: Array, d: Array, blo: Array, bext: Array,
                 t_max: Array | None = None) -> Array:
    """Sort key: dead bit (major) | 3-bit direction octant | 18-bit Morton.

    Dead rays (t_max < 0 lanes in the dense wave) sort last, so live lanes
    form a prefix — the phase-ladder compaction slices on that."""
    octant = (
        ((d[..., 0] < 0).astype(jnp.uint32) << 2)
        | ((d[..., 1] < 0).astype(jnp.uint32) << 1)
        | (d[..., 2] < 0).astype(jnp.uint32)
    )
    q = jnp.clip((o - blo) / bext * 64.0, 0, 63).astype(jnp.uint32)
    m = ((_expand_bits6(q[..., 2]) << 2) | (_expand_bits6(q[..., 1]) << 1)
         | _expand_bits6(q[..., 0]))
    k = (octant << jnp.uint32(18)) | (m & jnp.uint32(0x3FFFF))
    if t_max is not None:
        k = k | ((t_max < 0).astype(jnp.uint32) << jnp.uint32(21))
    return k


def make_sorted_isect(fn, bounds):
    """Wrap a batched intersector with sort -> traverse -> unsort."""
    blo = jnp.asarray(bounds[0], jnp.float32)
    bext = jnp.maximum(jnp.asarray(bounds[1], jnp.float32) - blo, 1e-9)

    def wrapped(o, d, t_max):
        k = ray_sort_key(o, d, blo, bext, t_max)
        order = jnp.argsort(k)
        h = fn(o[order], d[order], t_max[order])
        inv = jnp.argsort(order)
        return jax.tree.map(lambda x: x[inv], h)

    return wrapped
