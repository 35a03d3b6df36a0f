"""Counter-based, stateless random number generation.

The reference uses a stateful PCG32 per thread (`util/rng.h`); batched lanes want a
*pure function* of (seed, counter) so every lane of a ray batch derives its own
stream with no state. We use finalizing integer hashes (pcg-output / murmur-style
mixers, the same family the reference uses in `util/hash.h` MixBits) — each call
is a handful of VPU integer ops, no tables.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

_ONE_OVER_2_32 = jnp.float32(2.3283064365386963e-10)  # 0x1p-32


def mix_bits(v: Array) -> Array:
    """64-bit finalizer (reference util/hash.h:MixBits, splitmix64 finalizer).

    Operates on uint32 pairs packed as uint32 here: we use a 32-bit variant
    (murmur3 fmix32 strengthened) to stay in fast 32-bit integer ops.
    """
    v = jnp.asarray(v, jnp.uint32)
    v ^= v >> 16
    v *= jnp.uint32(0x7FEB352D)
    v ^= v >> 15
    v *= jnp.uint32(0x846CA68B)
    v ^= v >> 16
    return v


def hash_combine(*vals: Array) -> Array:
    """Combine integer streams into one well-mixed uint32."""
    h = jnp.uint32(0x9E3779B9)
    for v in vals:
        v = jnp.asarray(v, jnp.uint32)
        h = mix_bits(h ^ (v + jnp.uint32(0x9E3779B9) + (h << 6) + (h >> 2)))
    return h


def uint32_to_float01(u: Array) -> Array:
    """Map uint32 -> [0,1) float32 (reference rng.h Uniform<Float>)."""
    return jnp.minimum(
        jnp.asarray(u, jnp.uint32).astype(jnp.float32) * _ONE_OVER_2_32,
        jnp.float32(1.0 - 2**-24),
    )


def hash_float(*vals: Array) -> Array:
    return uint32_to_float01(hash_combine(*vals))


def pcg_permute(state: Array) -> Array:
    """PCG-XSH-RR output permutation on a 32-bit state (PCG family as in
    reference util/rng.h, reduced to 32-bit state)."""
    state = jnp.asarray(state, jnp.uint32)
    state = state * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> 28) + jnp.uint32(4))) ^ state) * jnp.uint32(277803737)
    return (word >> 22) ^ word
