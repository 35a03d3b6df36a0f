"""Per-level PointNet encoders for treeNet.

Rebuild of `nss_custom_layers.py` recursive_tree_level_encoder(_EPO): the
reference's 1x1 Conv2D stacks are shared-MLP einsums here (identical math, and
XLA batches all nodes of a level into single matmuls). Architecture:

SAH/point variant (nss_custom_layers.py:7):
  input (B, N, 3 axes, 1): 3x [1x1 conv C, relu] -> masked mean-pool over N ->
  3x regressor [1x1 conv, relu / relu / linear] -> 3 local thetas; plus
  stop-grad (scale, translate) mapping local [0,1] to node space.

EPO/primitive variant (:103):
  input (B, N, 9, 1) grouped as 3 axes x 3 vertices; first layer is a (1,3)
  stride-(1,3) conv = per-axis dense over the 3 vertex coords -> (B, N, 3, C),
  then as above.

Normalization (object_normalize, :46,:145): per-axis masked min/max of the
cloud inside the node; features scaled to [0,1) * layer_gamma + 1. The
min/max also produce the (scale, translate) that map predicted local thetas
back to node-relative thetas (call :97-99, stop-grad).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import common

# Encoder products run in float32 (HIGHEST): the predicted split positions
# feed a discrete tree rebuild, and a GPU's default may drop to TF32.
_P = jax.lax.Precision.HIGHEST

Array = jax.Array


class EncoderParams(NamedTuple):
    vert: Array | None  # (3, C) EPO first layer over vertex coords, else None
    w1: Array           # (Cin, C)
    w2: Array           # (C, C)
    w3: Array           # (C, C)
    r1: Array           # (C, C)
    r2: Array           # (C, C/2)
    r3: Array           # (C/2, 1)


def _he_uniform(key, shape):
    fan_in = shape[0]
    limit = np.sqrt(6.0 / fan_in)
    return jax.random.uniform(key, shape, jnp.float32, -limit, limit)


def _glorot_uniform(key, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return jax.random.uniform(key, shape, jnp.float32, -limit, limit)


def init_encoder(key, capacity: int, epo: bool) -> EncoderParams:
    ks = jax.random.split(key, 7)
    c = capacity
    return EncoderParams(
        vert=_he_uniform(ks[0], (3, c)) if epo else None,
        w1=_he_uniform(ks[1], (1 if epo else 1, c)) if not epo else _he_uniform(ks[1], (c, c)),
        w2=_he_uniform(ks[2], (c, c)),
        w3=_he_uniform(ks[3], (c, c)),
        r1=_he_uniform(ks[4], (c, c)),
        r2=_he_uniform(ks[5], (c, c // 2)),
        r3=_glorot_uniform(ks[6], (c // 2, 1)),
    )


def _normalize_points(points: Array, mask: Array, gamma: float):
    """points (..., N, 3), mask (..., N) -> features (..., N, 3), scale, translate."""
    m = mask[..., None]
    pmin = jnp.min(jnp.where(m > 0, points, common.BIG), axis=-2)   # (..., 3)
    pmax = jnp.max(jnp.where(m > 0, points, -common.BIG), axis=-2)
    pmin = jnp.minimum(pmin, pmax)
    ext = pmax - pmin
    inv = jnp.where(ext > 0, 1.0 / jnp.where(ext == 0, 1.0, ext), 0.0)
    feat = (points - pmin[..., None, :]) * inv[..., None, :] * gamma + 1.0
    feat = feat * m
    return feat, pmin, pmax


def _normalize_prims(prims: Array, mask: Array, gamma: float):
    """prims (..., N, 9) -> features (..., N, 3 axes, 3 verts), axis min/max."""
    v = jnp.stack(
        [prims[..., 0:3], prims[..., 3:6], prims[..., 6:9]], axis=-2
    )  # (..., N, 3 axes, 3 verts)
    m = mask[..., None, None]
    pmin = jnp.min(jnp.where(m > 0, v, common.BIG), axis=(-3, -1))  # (..., 3)
    pmax = jnp.max(jnp.where(m > 0, v, -common.BIG), axis=(-3, -1))
    pmin = jnp.minimum(pmin, pmax)
    ext = pmax - pmin
    inv = jnp.where(ext > 0, 1.0 / jnp.where(ext == 0, 1.0, ext), 0.0)
    feat = (v - pmin[..., None, :, None]) * inv[..., None, :, None] * gamma + 1.0
    feat = feat * m
    return feat, pmin, pmax


def apply_encoder(
    params: EncoderParams,
    cloud: Array,
    bounds: Array,
    mask: Array,
    gamma: float = 4.0,
):
    """-> (lthetas (..., 3), scale (..., 3), translate (..., 3)).

    thetas = lthetas * scale + translate maps the prediction from the tight
    masked-cloud box to node-bounds-relative coordinates (reference call()).
    Cloud gradient is stopped (the reference stop-records the encoder input);
    gradients flow to the encoder weights via the custom two-phase scheme in
    treenet.train (jax.checkpoint makes that free here).
    """
    cloud = jax.lax.stop_gradient(cloud)
    mask = jax.lax.stop_gradient(mask)
    epo = cloud.shape[-1] == 9

    if epo:
        feat, pmin, pmax = _normalize_prims(cloud, mask, gamma)  # (..., N, 3, 3v)
        h = jnp.einsum("...nav,vc->...nac", feat, params.vert, precision=_P)
        h = jax.nn.relu(h)
        h = jax.nn.relu(jnp.einsum("...nac,cd->...nad", h, params.w1, precision=_P))
    else:
        feat, pmin, pmax = _normalize_points(cloud, mask, gamma)  # (..., N, 3)
        h = jax.nn.relu(feat[..., None] * params.w1[0][None])  # (..., N, 3, C): 1x1 conv on 1 channel
        # note: SAH variant's first 1x1 conv maps the single channel to C
    h = jax.nn.relu(jnp.einsum("...nac,cd->...nad", h, params.w2, precision=_P))
    h = jax.nn.relu(jnp.einsum("...nac,cd->...nad", h, params.w3, precision=_P))

    # masked mean pool over the cloud (global descriptor)
    n = jnp.maximum(jnp.sum(mask, axis=-1), 1.0)  # (...,)
    pooled = jnp.sum(h * mask[..., None, None], axis=-3) / n[..., None, None]  # (..., 3, C)

    g = jax.nn.relu(jnp.einsum("...ac,cd->...ad", pooled, params.r1, precision=_P))
    g = jax.nn.relu(jnp.einsum("...ac,cd->...ad", g, params.r2, precision=_P))
    lthetas = jnp.einsum("...ac,cd->...ad", g, params.r3, precision=_P)[..., 0]  # (..., 3)

    bmin = bounds[..., 0:3]
    bmax = bounds[..., 3:6]
    ext = bmax - bmin
    inv = jnp.where(ext > 0, 1.0 / jnp.where(ext == 0, 1.0, ext), 0.0)
    scale = jax.lax.stop_gradient((pmax - pmin) * inv)
    translate = jax.lax.stop_gradient((pmin - bmin) * inv)
    return lthetas, scale, translate
